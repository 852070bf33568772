"""The port's SO(3) algebra (``repro_torch.models.gnn.so3``) against the
reference's on the CPU, and its own identities.

The reference's ``real_sph_harm`` and ``wigner_stack`` run eagerly, once per
module (about 4 s at l_max = 6).  Tolerances: spherical harmonics and
Wigner matrices within 1e-5 of the reference's; the Gaunt tensors bit-equal
(both are the same numpy code); Y(R d) = D(R) Y(d) within rtol 1e-4, atol
1e-5 and D D^T = 1 within 1e-5, as ``tests/test_so3.py`` holds the
reference.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import so3 as jso3
from repro_torch.models.gnn import so3

L_MAX = 6
TOL = dict(rtol=1e-5, atol=1e-5)


def _random_rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def _dirs(seed: int, n: int = 48) -> np.ndarray:
    """Unit vectors, the poles and a point on the equator among them."""
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d[:3] = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """The reference's Y (48 directions) and Wigner stack (16 rotations) at
    l_max = 6, computed once."""
    rng = np.random.default_rng(11)
    R = np.stack([_random_rotation(rng) for _ in range(16)]).astype(np.float32)
    d = _dirs(10)
    return {
        "dirs": d, "R": R,
        "Y": np.asarray(jso3.real_sph_harm(jnp.asarray(d), L_MAX)),
        "Ds": [np.asarray(D) for D in jso3.wigner_stack(jnp.asarray(R), L_MAX)],
    }


def test_index_helpers_match_the_reference():
    for l_max in range(8):
        assert so3.n_coeffs(l_max) == jso3.n_coeffs(l_max)
        for m in range(-l_max, l_max + 1):
            assert so3.lm_index(l_max, m) == jso3.lm_index(l_max, m)


def test_real_sph_harm_matches_the_reference(reference):
    got = so3.real_sph_harm(torch.from_numpy(reference["dirs"]), L_MAX)
    assert got.shape == (48, 49)
    np.testing.assert_allclose(got.numpy(), reference["Y"], **TOL)
    # leading dims are batch dims
    lead = so3.real_sph_harm(torch.from_numpy(reference["dirs"]).reshape(6, 8, 3), L_MAX)
    assert torch.equal(lead.reshape(48, 49), got)


def test_wigner_stack_and_block_diagonal_match_the_reference(reference):
    R = torch.from_numpy(reference["R"])
    got = so3.wigner_stack(R, L_MAX)
    assert [tuple(D.shape) for D in got] == [(16, 2 * l + 1, 2 * l + 1) for l in range(L_MAX + 1)]
    for l, (D, want) in enumerate(zip(got, reference["Ds"])):
        np.testing.assert_allclose(D.numpy(), want, err_msg=f"l={l}", **TOL)
    full = so3.block_diag_wigner(R[:3], 2)
    want = np.asarray(jso3.block_diag_wigner(jnp.asarray(reference["R"][:3]), 2))
    np.testing.assert_allclose(full.numpy(), want, **TOL)
    assert len(so3.wigner_stack(R, 0)) == 1 and torch.equal(so3.wigner_stack(R, 0)[0], torch.ones(16, 1, 1))


def test_rotation_to_z_matches_the_reference_zero_vectors_included():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[0], v[1], v[2], v[3] = [0, 0, 2.0], [0, 0, -0.5], [0, 0, 0], [1e-12, 0, 0]
    got = so3.rotation_to_z(torch.from_numpy(v)).numpy()
    want = np.asarray(jso3.rotation_to_z(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(np.isfinite(got)) and np.array_equal(got[2], np.zeros((3, 3), np.float32))
    d = v[4:] / np.linalg.norm(v[4:], axis=1, keepdims=True)
    z = np.einsum("eij,ej->ei", got[4:], d)
    np.testing.assert_allclose(z, np.tile([0, 0, 1.0], (60, 1)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got[4:]), np.ones(60), atol=1e-5)


GAUNT_TRIPLES = [(l1, l2, l3) for l1 in range(3) for l2 in range(3) for l3 in range(6)] + [
    (6, 6, 0), (3, 3, 6), (6, 2, 4), (1, 6, 5), (6, 6, 12), (4, 6, 3)]


def test_real_gaunt_equals_the_reference_bit_for_bit():
    for triple in GAUNT_TRIPLES:
        got, want = so3.real_gaunt(*triple), jso3.real_gaunt(*triple)
        assert got.dtype == want.dtype and np.array_equal(got, want), triple
    assert np.array_equal(so3._real_sph_harm_np(_dirs(3).astype(np.float64), L_MAX),
                          jso3._real_sph_harm_np(_dirs(3).astype(np.float64), L_MAX))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wigner_rotates_sph_harm(seed):
    """Y(R d) = D^l(R) Y(d) for every l <= 6, on the port alone."""
    rng = np.random.default_rng(seed)
    R = _random_rotation(rng)
    d = _dirs(100 + seed, 32).astype(np.float64)
    Y = so3.real_sph_harm(torch.from_numpy(d), L_MAX).numpy()
    Y_rot = so3.real_sph_harm(torch.from_numpy(d @ R.T), L_MAX).numpy()
    Ds = so3.wigner_stack(torch.from_numpy(R)[None], L_MAX)
    for l in range(L_MAX + 1):
        sl = slice(l * l, (l + 1) ** 2)
        np.testing.assert_allclose(Y_rot[:, sl], Y[:, sl] @ Ds[l][0].numpy().T, rtol=1e-4, atol=1e-5)


def test_wigner_is_orthogonal():
    rng = np.random.default_rng(3)
    R = torch.from_numpy(np.stack([_random_rotation(rng) for _ in range(4)]).astype(np.float32))
    for l, D in enumerate(so3.wigner_stack(R, L_MAX)):
        eye = np.eye(2 * l + 1)[None].repeat(4, 0)
        np.testing.assert_allclose((D @ D.transpose(-1, -2)).numpy(), eye, atol=1e-5)
