"""Sharded checkpoints: each rank writes only its shards, and a load
restores each shard straight into its rank's layout.

Port of ``onebit_tpu/ckpt/sharded.py`` on ``torch.distributed.checkpoint``
(DCP). JAX's state directory is orbax OCDBT, which needs orbax and so jax,
so the port writes a format of its own:

* ``<path>/config.json``, as the native format has it;
* ``<path>/metadata.json``: ``{"format": "onebit-sharded-torch"}``;
* ``<path>/state/``: DCP's files, one tensor a native checkpoint key
  (``embed_tokens``, ``layers.q_proj.latent``, ...) in the port's layout
  (packed words K-major). A leaf split over the ranks of a ``(data,
  model)`` mesh (``parallel/sharding.py``) is written as a
  ``DTensor`` of the rank's block, so each rank writes its block, with its
  place in the full tensor; a whole leaf is written once.

A load on a mesh builds each rank's blocks from DCP's metadata (the full
shapes give the layout) and lets DCP read into them: no rank ever holds
the full tree. Without a mesh the full tree loads on one device.
JAX's ``"onebit-sharded"`` directories do not load here
(:func:`check_not_orbax`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.parallel.mesh import Mesh2D
from onebit_tpu_torch.parallel.sharding import (MeshLayout, local_shape,
                                                mesh_layout, named_leaves,
                                                unflatten)

FORMAT = "onebit-sharded-torch"
JAX_FORMAT = "onebit-sharded"


def _format(path: str) -> Optional[str]:
    meta = os.path.join(path, "metadata.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f).get("format")


def is_sharded_ckpt(path: str) -> bool:
    """A directory this module wrote."""
    return _format(path) == FORMAT


def check_not_orbax(path: str) -> None:
    """Exit nonzero, saying why, on the JAX package's sharded directory."""
    if _format(path) == JAX_FORMAT:
        raise SystemExit(
            f"{path} is the JAX package's sharded checkpoint (an orbax OCDBT "
            f"tree, which needs orbax and jax to read); the port reads its "
            f"own sharded format ({FORMAT!r}, ckpt/sharded.py): write a "
            f"native checkpoint of it with the JAX package, then `convert "
            f"--format sharded` here")


def _device_mesh(mesh: Mesh2D):
    """The ``DeviceMesh`` of the rank groups that split something, with its
    dims in the order the blocks nest: ``model`` outer, ``data`` inner
    (``parallel/sharding.py`` cuts a model shard again over the data
    ranks), so that ``[Shard(a), Shard(a)]`` places rank ``(i, j)``'s block
    at ``j·d + i`` of ``m·d``. Returns ``(device mesh, dim names)``."""
    from torch.distributed.device_mesh import DeviceMesh
    d, m = mesh.shape
    kind = mesh.device.type
    if m == 1:
        return DeviceMesh.from_group(mesh.data.group, kind), ("data",)
    if d == 1:
        return DeviceMesh.from_group(mesh.model.group, kind), ("model",)
    ranks = torch.arange(d * m).reshape(d, m).T
    return (DeviceMesh.from_group([mesh.model.group, mesh.data.group], kind,
                                  mesh=ranks,
                                  mesh_dim_names=("model", "data")),
            ("model", "data"))


def dcp_dict(flat: Dict[str, torch.Tensor], split: MeshLayout,
             mesh: Optional[Mesh2D]) -> Dict[str, Any]:
    """DCP's state dict of a rank's flat tensors: a split key's block as a
    ``DTensor`` sharded along its axes, every other tensor as itself. A
    ``DTensor`` wraps the block without a copy, so a load writes into
    it."""
    if mesh is None or not (split.data or split.model):
        return dict(flat)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    device_mesh, dims = _device_mesh(mesh)
    out: Dict[str, Any] = {}
    for key, t in flat.items():
        axes = {"data": split.data.get(key), "model": split.model.get(key)}
        if all(axes[n] is None for n in dims):
            out[key] = t
            continue
        out[key] = DTensor.from_local(
            t, device_mesh, [Replicate() if axes[n] is None else
                             Shard(axes[n]) for n in dims], run_check=False)
    return out


def save_dcp(state_dir: str, flat: Dict[str, torch.Tensor],
             split: MeshLayout, mesh: Optional[Mesh2D]) -> None:
    """Write ``flat`` (every rank's, on a mesh: a collective)."""
    import torch.distributed.checkpoint as dcp
    sd = dcp_dict({k: v.detach() for k, v in flat.items()}, split, mesh)
    dcp.save(sd, checkpoint_id=state_dir, no_dist=mesh is None)


def load_dcp(state_dir: str, flat: Dict[str, torch.Tensor],
             split: MeshLayout, mesh: Optional[Mesh2D]) -> None:
    """Read ``state_dir`` into ``flat``'s tensors, in place (the rank's
    blocks of the split keys)."""
    import torch.distributed.checkpoint as dcp
    dcp.load(dcp_dict(flat, split, mesh), checkpoint_id=state_dir,
             no_dist=mesh is None)


def stored_shapes(state_dir: str) -> Dict[str, tuple]:
    """``{key: (full shape, dtype)}`` of the tensors under ``state_dir``."""
    from torch.distributed.checkpoint import FileSystemReader
    meta = FileSystemReader(state_dir).read_metadata().state_dict_metadata
    return {k: (tuple(m.size), m.properties.dtype) for k, m in meta.items()
            if hasattr(m, "size")}


def save_sharded(path: str, config: BitLlamaConfig, params: Dict[str, Any],
                 *, mesh: Optional[Mesh2D] = None,
                 layout: MeshLayout = MeshLayout({}, {})) -> None:
    """Write a sharded checkpoint of ``params``: a full tree (no mesh), or
    on ``mesh`` every rank's tree split by ``layout`` (a collective; each
    rank writes its blocks, rank 0 the two json files)."""
    path = os.path.abspath(path)
    if mesh is None or mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        config.save_json(os.path.join(path, "config.json"))
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump({"format": FORMAT, "version": 1}, f)
    save_dcp(os.path.join(path, "state"), dict(named_leaves(params)),
             layout, mesh)


def load_sharded(path: str, *, mesh: Optional[Mesh2D] = None,
                 dtype_override: Optional[torch.dtype] = None,
                 device=None) -> Dict[str, Any]:
    """``{"config", "params"}`` of a sharded checkpoint (and ``"layout"``
    on a mesh). On ``mesh``: this rank's tree, each split leaf's block read
    straight from the files onto ``mesh.device`` (the layout of
    ``parallel/sharding.py`` ``mesh_layout`` on the stored full shapes).
    Without: the full tree on ``device``. ``dtype_override`` casts every
    floating leaf after the read."""
    check_not_orbax(path)
    if not is_sharded_ckpt(path):
        raise ValueError(f"{path} is not a sharded checkpoint")
    path = os.path.abspath(path)
    config = BitLlamaConfig.from_json(os.path.join(path, "config.json"))
    state_dir = os.path.join(path, "state")
    shapes = stored_shapes(state_dir)
    layout = MeshLayout({}, {})
    if mesh is None:
        from onebit_tpu_torch.utils.device import resolve_device
        dev = resolve_device(device)
    else:
        dev = mesh.device
        layout = mesh_layout({k: s for k, (s, _) in shapes.items()}, config,
                             mesh.shape)
    flat = {}
    for k, (s, dt) in shapes.items():
        if mesh is not None:
            d, m = mesh.shape
            s = local_shape(local_shape(s, layout.model.get(k), m),
                            layout.data.get(k), d)
        flat[k] = torch.empty(s, dtype=dt, device=dev)
    load_dcp(state_dir, flat, layout, mesh)
    if dtype_override is not None:
        flat = {k: v.to(dtype_override) if v.is_floating_point() else v
                for k, v in flat.items()}
    out = {"config": config, "params": unflatten(flat)}
    if mesh is not None:
        out["layout"] = layout
    return out
