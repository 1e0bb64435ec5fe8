"""Sharded checkpoints: each rank writes only its shards, and a load
restores each shard straight into its rank's layout.

Port of ``onebit_tpu/ckpt/sharded.py`` on ``torch.distributed.checkpoint``
(DCP). JAX's state directory is orbax OCDBT, which needs orbax and so jax,
so the port writes a format of its own:

* ``<path>/config.json``, as the native format has it;
* ``<path>/metadata.json``: ``{"format": "onebit-sharded-torch"}``;
* ``<path>/state/``: DCP's files, one tensor a native checkpoint key
  (``embed_tokens``, ``layers.q_proj.latent``, ...) in the port's layout
  (packed words K-major). A leaf split over the ranks of a data axis
  (``parallel/sharding.py``) is written as a ``DTensor`` of the rank's
  block, so each rank writes its block; a whole leaf is written once.

A load with a group builds each rank's blocks from DCP's metadata (the
full shapes give the layout) and lets DCP read into them: no rank ever
holds the full tree. Without a group the full tree loads on one device.
JAX's ``"onebit-sharded"`` directories do not load here
(:func:`check_not_orbax`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.parallel.mesh import DataGroup
from onebit_tpu_torch.parallel.sharding import (Layout, local_shape,
                                                named_leaves, param_layout,
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


def _mesh(group: DataGroup):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh.from_group(group.group, group.device.type)


def dcp_dict(flat: Dict[str, torch.Tensor], split: Dict[str, int],
             group: Optional[DataGroup]) -> Dict[str, Any]:
    """DCP's state dict of a rank's flat tensors: a split key's block as a
    ``DTensor`` sharded along its axis, every other tensor as itself.
    A ``DTensor`` wraps the block without a copy, so a load writes into
    it."""
    if group is None or not split:
        return dict(flat)
    from torch.distributed.tensor import DTensor, Shard
    mesh = _mesh(group)
    out: Dict[str, Any] = {}
    for key, t in flat.items():
        out[key] = (DTensor.from_local(t, mesh, [Shard(split[key])],
                                       run_check=False)
                    if key in split else t)
    return out


def save_dcp(state_dir: str, flat: Dict[str, torch.Tensor],
             split: Dict[str, int], group: Optional[DataGroup]) -> None:
    """Write ``flat`` (every rank's, in a group: a collective)."""
    import torch.distributed.checkpoint as dcp
    sd = dcp_dict({k: v.detach() for k, v in flat.items()}, split, group)
    dcp.save(sd, checkpoint_id=state_dir, no_dist=group is None)


def load_dcp(state_dir: str, flat: Dict[str, torch.Tensor],
             split: Dict[str, int], group: Optional[DataGroup]) -> None:
    """Read ``state_dir`` into ``flat``'s tensors, in place (the rank's
    blocks of the split keys)."""
    import torch.distributed.checkpoint as dcp
    dcp.load(dcp_dict(flat, split, group), checkpoint_id=state_dir,
             no_dist=group is None)


def stored_shapes(state_dir: str) -> Dict[str, tuple]:
    """``{key: (full shape, dtype)}`` of the tensors under ``state_dir``."""
    from torch.distributed.checkpoint import FileSystemReader
    meta = FileSystemReader(state_dir).read_metadata().state_dict_metadata
    return {k: (tuple(m.size), m.properties.dtype) for k, m in meta.items()
            if hasattr(m, "size")}


def save_sharded(path: str, config: BitLlamaConfig, params: Dict[str, Any],
                 *, group: Optional[DataGroup] = None,
                 layout: Optional[Layout] = None) -> None:
    """Write a sharded checkpoint of ``params``: a full tree (no group), or
    with ``group`` every rank's tree split by ``layout`` (a collective;
    each rank writes its blocks, rank 0 the two json files)."""
    path = os.path.abspath(path)
    if group is None or group.rank == 0:
        os.makedirs(path, exist_ok=True)
        config.save_json(os.path.join(path, "config.json"))
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump({"format": FORMAT, "version": 1}, f)
    save_dcp(os.path.join(path, "state"), dict(named_leaves(params)),
             layout or {}, group)


def load_sharded(path: str, *, group: Optional[DataGroup] = None,
                 dtype_override: Optional[torch.dtype] = None,
                 device=None) -> Dict[str, Any]:
    """``{"config", "params"}`` of a sharded checkpoint (and ``"layout"``
    with a group). With ``group``: this rank's tree, each split leaf's
    block read straight from the files onto ``group.device`` (the layout of
    ``parallel/sharding.py`` ``param_layout`` on the stored full shapes).
    Without: the full tree on ``device``. ``dtype_override`` casts every
    floating leaf after the read."""
    check_not_orbax(path)
    if not is_sharded_ckpt(path):
        raise ValueError(f"{path} is not a sharded checkpoint")
    path = os.path.abspath(path)
    config = BitLlamaConfig.from_json(os.path.join(path, "config.json"))
    state_dir = os.path.join(path, "state")
    shapes = stored_shapes(state_dir)
    if group is None:
        from onebit_tpu_torch.utils.device import resolve_device
        dev, n, layout = resolve_device(device), 1, {}
    else:
        dev, n = group.device, group.size
        layout = param_layout({k: s for k, (s, _) in shapes.items()}, n)
    flat = {k: torch.empty(local_shape(s, layout.get(k), n), dtype=dt,
                           device=dev)
            for k, (s, dt) in shapes.items()}
    load_dcp(state_dir, flat, layout, group)
    if dtype_override is not None:
        flat = {k: v.to(dtype_override) if v.is_floating_point() else v
                for k, v in flat.items()}
    out = {"config": config, "params": unflatten(flat)}
    if group is not None:
        out["layout"] = layout
    return out
