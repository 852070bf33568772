"""Device meshes of the sharded LM (the port of the reference's
``launch/mesh.py``).

Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2, data=16,
model=16), 512 ranks; the pod axis carries pure data parallelism: a
batch splits over ``(pod, data)``, parameters over ``data`` and ``model``
within a pod, replicated across pods.  The sharded LM runs on both (its
plan from ``MeshPlan.from_mesh``).  A ``DeviceMesh`` needs a live process
group of that many ranks, one per card under NCCL; ``production_plan``
gives the production meshes' plans from their sizes alone, which is all
``param_specs`` and the other specs read, and on which the dry run counts
a rank's sharded step.  Functions, so importing this module touches no
process group.
"""
from __future__ import annotations

from repro_torch.core.matrices import resolve_device
from repro_torch.shard.plans import MeshPlan

PRODUCTION = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape, axes, device):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape, axes = PRODUCTION[multi_pod]
    return _mesh(shape, axes, device)


def make_test_mesh(data: int = 2, model: int = 2, device="cuda"):
    """A small (data, model) mesh over the ranks of the process group."""
    return _mesh((data, model), ("data", "model"), device)


def production_plan(*, multi_pod: bool = False) -> MeshPlan:
    """The production mesh's plan, built from its sizes (no process group),
    at its first rank's coordinates: the specs read only the sizes."""
    (*rows, model), _ = PRODUCTION[multi_pod]
    return MeshPlan(
        pod_axis="pod" if multi_pod else None, data_axis="data", model_axis="model",
        pod_size=rows[0] if multi_pod else 1, data_size=rows[-1], model_size=model,
    )
