"""Port kernels against the reference: the packed layout and ``bitmm``.

Inputs are drawn with numpy and handed to both packages.  The reference
kernel runs as the reference's own tests run it on the CPU: the Pallas
kernel in interpret mode, or its jnp oracle.  Tolerance is exact word
equality (uint32 view of the port's int32 words).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matrices as jm
from repro.kernels import ref as jref
from repro.kernels.bitmm import bitmm_pallas
from repro_torch.core import matrices as tm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitmm import bitmm_cuda


def _bits(rng, shape, density):
    bits = rng.random(shape) < density
    bits[..., 31 :: 32] |= rng.random(bits[..., 31::32].shape) < 0.5  # bit 31
    return bits


def _bool_product(lhs, rhs):
    """numpy Boolean matmul (0/1 float32 product, exact at these sizes)."""
    return (lhs.astype(np.float32) @ rhs.astype(np.float32)) > 0


#: the reference's packing and jnp bitmm oracle, jitted: one compile per
#: shape instead of one per operation
_jpack = jax.jit(jm.pack_bits)
_jbitmm_ref = jax.jit(jref.bitmm_ref)


def _both_packed(bits):
    """(reference uint32 words, port int32 words) of the same bits."""
    return _jpack(jnp.asarray(bits)), tm.pack_bits(torch.from_numpy(bits))


# ---------------------------------------------------------------------- #
# packed layout
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 128, 300])
def test_pack_bits_matches_reference_words(n):
    rng = np.random.default_rng(n)
    bits = rng.random((2, 5, n)) < 0.4
    bits[0, 0, 31 % n] = True
    jw, tw = _both_packed(bits)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tm.to_reference(tw), np.asarray(jw))
    np.testing.assert_array_equal(
        tm.unpack_bits(tw, n).numpy(), np.asarray(jm.unpack_bits(jw, n))
    )


def test_pack_bits_sets_bit_31():
    bits = np.zeros((1, 64), bool)
    bits[0, 31] = bits[0, 63] = True
    words = tm.pack_bits(torch.from_numpy(bits))
    assert words.tolist() == [[-(2**31), -(2**31)]]
    assert tm.to_reference(words).tolist() == [[2**31, 2**31]]


def test_reference_states_round_trip():
    rng = np.random.default_rng(3)
    T = rng.random((3, 128, 128)) < 0.1
    words = np.asarray(jm.pack_bits(jnp.asarray(T)))
    for ref_state in (T, words, T[0, 0]):
        t = tm.from_reference(ref_state, device="cpu")
        assert t.dtype in (torch.bool, torch.int32)
        back = tm.to_reference(t)
        assert back.dtype == ref_state.dtype
        np.testing.assert_array_equal(back, ref_state)
    with pytest.raises(TypeError):
        tm.from_reference(np.zeros(3, np.float32), device="cpu")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.resolve_device("cuda")


# ---------------------------------------------------------------------- #
# bitmm_ref against the reference kernel and its oracle
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def pallas_cases():
    """Reference Pallas kernel (interpret mode) on one square and one
    rectangular shape, computed once: ``{name: (lhs_bits, rhs_bits, out)}``."""
    out = {}
    rng = np.random.default_rng(11)
    for name, (r, n) in {"square128": (128, 128), "rect32x256": (32, 256)}.items():
        lhs, rhs = _bits(rng, (2, r, n), 0.1), _bits(rng, (2, n, n), 0.1)
        jl, jr = jm.pack_bits(jnp.asarray(lhs)), jm.pack_bits(jnp.asarray(rhs))
        got = bitmm_pallas(jl, jr, ti=min(r, 128), tw=n // 32, tk=n, interpret=True)
        out[name] = (lhs, rhs, np.asarray(got))
    return out


@pytest.mark.parametrize("name", ["square128", "rect32x256"])
def test_bitmm_ref_matches_pallas_interpret(pallas_cases, name):
    lhs, rhs, want = pallas_cases[name]
    got = ref.bitmm_ref(
        tm.pack_bits(torch.from_numpy(lhs)), tm.pack_bits(torch.from_numpy(rhs))
    )
    np.testing.assert_array_equal(tm.to_reference(got), want)


def _against_jax_ref(lhs, rhs):
    jl, tl = _both_packed(lhs)
    jr, tr = _both_packed(rhs)
    got = ref.bitmm_ref(tl, tr)
    np.testing.assert_array_equal(
        tm.to_reference(got), np.asarray(_jbitmm_ref(jl, jr))
    )
    np.testing.assert_array_equal(
        tm.unpack_bits(got, rhs.shape[-1]).numpy(), _bool_product(lhs, rhs)
    )


@pytest.mark.parametrize("n", [128, 256, 512])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
def test_bitmm_ref_matches_reference_square(n, b, density):
    rng = np.random.default_rng(n * 1000 + b * 10 + int(density * 10))
    _against_jax_ref(_bits(rng, (b, n, n), density), _bits(rng, (b, n, n), density))


@pytest.mark.parametrize(
    "r,n", [(32, 256), (64, 128), (96, 128), (128, 512), (256, 128)]
)
def test_bitmm_ref_matches_reference_rectangular(r, n):
    rng = np.random.default_rng(r * 1000 + n)
    _against_jax_ref(_bits(rng, (2, r, n), 0.15), _bits(rng, (2, n, n), 0.15))


def test_bitmm_ref_output_width_independent_of_k():
    """rhs words need not number k/32 (the reference oracle assumes so)."""
    rng = np.random.default_rng(5)
    lhs, rhs = _bits(rng, (2, 40, 64), 0.2), _bits(rng, (2, 64, 96), 0.2)
    got = ref.bitmm_ref(
        tm.pack_bits(torch.from_numpy(lhs)), tm.pack_bits(torch.from_numpy(rhs))
    )
    assert got.shape == (2, 40, 3)
    np.testing.assert_array_equal(
        tm.unpack_bits(got, 96).numpy(), _bool_product(lhs, rhs)
    )


# ---------------------------------------------------------------------- #
# ops.bitmm dispatch
# ---------------------------------------------------------------------- #


def test_ops_bitmm_on_cpu_takes_plain_version_without_launching():
    rng = np.random.default_rng(9)
    lhs = tm.pack_bits(torch.from_numpy(_bits(rng, (3, 96, 128), 0.2)))
    rhs = tm.pack_bits(torch.from_numpy(_bits(rng, (3, 128, 128), 0.2)))
    before = ops.launches
    assert torch.equal(ops.bitmm(lhs, rhs), ref.bitmm_ref(lhs, rhs))
    assert ops.launches == before


def test_ops_bitmm_off_cpu_never_takes_plain_version():
    """Off the CPU the wrapper goes to the kernel's entry: CPU operands
    mixed with others raise there, and ``meta`` operands (the dry run's)
    get an empty output of the product's shape and launch nothing."""
    lhs = torch.empty((1, 64, 4), dtype=torch.int32, device="meta")
    rhs = torch.empty((1, 128, 4), dtype=torch.int32, device="meta")
    before = ops.launches
    with pytest.raises(ValueError, match="not CUDA"):
        ops.bitmm(lhs.new_zeros(lhs.shape, device="cpu"), rhs)
    out = ops.bitmm(lhs, rhs)
    assert out.is_meta and out.shape == (1, 64, 4) and out.dtype == torch.int32
    assert ops.launches == before


def test_bitmm_cuda_rejects_cpu_tensors():
    lhs = torch.zeros((1, 4, 2), dtype=torch.int32)
    rhs = torch.zeros((1, 64, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="not CUDA"):
        bitmm_cuda(lhs, rhs)


def test_bitmm_path_cuda_rejects_cpu_tensors_and_bad_thresholds():
    from repro_torch.kernels.bitmm import bitmm_path_cuda

    lhs = torch.zeros((1, 4, 2), dtype=torch.int32)
    rhs = torch.zeros((1, 64, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="not CUDA"):
        bitmm_path_cuda(lhs, rhs, sparse_max_bits=0)
    with pytest.raises(ValueError, match="not an int32"):
        bitmm_path_cuda(lhs, rhs, sparse_max_bits=2**31)


def test_max_lhs_words_fits_the_kernels_shared_memory():
    """The wrapper's MAX_LHS_WORDS is the most lhs words per row whose
    union and staging list fit beside the ring in a block's shared memory,
    by the constants of csrc/bitmm.cu."""
    import re

    from repro_torch.kernels import bitmm as kbitmm

    src = kbitmm.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    tm, stages, dwt, smem = (const(n) for n in ("TM", "STAGES", "DWT", "kMaxSmem"))
    slot = tm + 32 * 32 * dwt

    def fits(words):
        return 4 * (tm + 4 + 2 * words + stages * slot) <= smem

    assert kbitmm.MAX_LHS_WORDS % 4 == 0
    assert fits(kbitmm.MAX_LHS_WORDS) and not fits(kbitmm.MAX_LHS_WORDS + 4)
