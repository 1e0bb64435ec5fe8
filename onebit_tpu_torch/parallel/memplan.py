"""Memory plans without a card: one rank's real step run on fake tensors,
and its peak checked against a budget.

Port of ``onebit_tpu/parallel/memplan.py``. JAX reads XLA's buffer
assignment of an ahead-of-time compile. Torch has no such compiler, so the
port runs the step itself, rank 0's, on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes, no
storage) over a fake process group of N ranks
(``torch.testing._internal.distributed.fake_pg.FakeStore``: every
collective returns at once; on a ``(data, model)`` mesh its model and data
groups are fake groups of it), and reads the peak of the bytes its tensors
hold (:class:`_Peak`, a dispatch mode that counts each storage while it
lives). These are private or testing APIs of torch (checked on 2.11 and
2.13).

What runs is the kernel path: each kernel wrapper, given fake tensors,
makes its kernel's outputs (``utils/device.py`` ``is_fake``), so the count
holds what the kernels hold (B11's output and log-sum-exp, its backward's
gradients; K1-K3's and B4's fp32 products; B9's and B10's contexts), not
the plain versions' (the plain attention's ``[B, H, S, S]`` scores would be
537 MB a row at 2048 tokens in fp32). The fake tensors live on the CPU
device, the same on a machine with a card and without one (autograd on fake
CUDA tensors needs torch built for CUDA); the peak is the same either way.

The peak counts tensors only, as ``torch.cuda.max_memory_allocated`` does:
not the caching allocator's reserve, nor cuBLAS's workspace, nor a
library's host buffers. :func:`analytic_train_bytes` is the hand model,
arithmetic on shapes, equal to JAX's for the same configuration.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from onebit_tpu_torch.model.config import BitLlamaConfig

GIB = 2 ** 30


@dataclasses.dataclass
class MemReport:
    """One rank's memory accounting of one step."""
    peak_bytes: int          # the tensors' peak over the step
    argument_bytes: int      # resident inputs: params, moments, teacher,
    #                          batch (or cache)
    output_bytes: int        # what the step made that outlives it
    temp_bytes: int          # the peak above the inputs
    label: str = ""

    @property
    def peak_gb(self) -> float:
        return self.peak_bytes / GIB

    def check(self, hbm_gb: float) -> None:
        """Raise ``MemoryError`` with the accounting when the peak passes
        ``hbm_gb`` GiB (the point of ``--dry-compile``)."""
        budget = int(hbm_gb * GIB)
        if self.peak_bytes > budget:
            raise MemoryError(
                f"{self.label}: per-card peak {self.peak_gb:.2f} GiB "
                f"exceeds the {hbm_gb:g} GiB budget (resident inputs "
                f"{self.argument_bytes / GIB:.2f} + transient "
                f"{self.temp_bytes / GIB:.2f} GiB; shard over more ranks or "
                f"shrink batch/seq)")

    def __str__(self) -> str:
        return (f"{self.label}: peak {self.peak_gb:.2f} GiB/card (inputs "
                f"{self.argument_bytes / GIB:.2f}, transient "
                f"{self.temp_bytes / GIB:.2f}, outputs "
                f"{self.output_bytes / GIB:.2f})")


class _FakeRanks:
    """A fake process group of ``n`` ranks (this process rank 0) and fake
    tensors over the block; both undone on exit."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.testing._internal.distributed.fake_pg import FakeStore
        if dist.is_initialized():
            raise RuntimeError("a memory plan runs its own fake process "
                               "group: call it outside torch.distributed")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=self.n)
        self.mode = FakeTensorMode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.mode.__exit__(*exc)
        finally:
            dist.destroy_process_group()


def _tensors(*trees):
    """Every tensor in nested dicts, tuples and lists."""
    for tree in trees:
        if torch.is_tensor(tree):
            yield tree
        elif isinstance(tree, dict):
            yield from _tensors(*tree.values())
        elif isinstance(tree, (tuple, list)):
            yield from _tensors(*tree)


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        key = id(t.untyped_storage())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


# ops that return no tensor (autograd asks the device of every tensor it
# meets): skipped before the output walk, half of a step's dispatches
_NO_STORAGE = (torch.ops.prim.device.default,)


class _Peak(TorchDispatchMode):
    """The bytes of the live storages, and their peak: each op's outputs'
    storages are counted once, until they are freed (a weak reference's
    finalizer). It gives ``torch.distributed._tools.mem_tracker``'s
    ``MemTracker`` total (15.642 GiB both, for the 7B step at (8, 1)) in
    about two thirds of its time."""

    def __init__(self, tensors):
        super().__init__()
        self.live: dict = {}
        self.now = 0
        for t in tensors:
            self._add(t)
        self.peak = self.now

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.live:
            self.live[key] = st.nbytes()
            self.now += self.live[key]
            weakref.finalize(st, self._drop, key)

    def _drop(self, key) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _NO_STORAGE:
            return out
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._add(t)
        self.peak = max(self.peak, self.now)
        return out


def _measure(label: str, inputs, step) -> MemReport:
    """Run ``step()`` under a :class:`_Peak` that holds ``inputs``."""
    tensors = list(_tensors(inputs))
    argument = _nbytes(tensors)
    tracker = _Peak(tensors)
    with tracker:
        out = step()
    del out
    return MemReport(peak_bytes=tracker.peak, argument_bytes=argument,
                     output_bytes=max(tracker.now - argument, 0),
                     temp_bytes=tracker.peak - argument, label=label)


def dry_run_train(config: BitLlamaConfig, mesh_shape: Tuple[int, int],
                  batch_size: int, seq_len: int, *, kd_cfg=None,
                  train_cfg=None, compute_dtype=torch.bfloat16,
                  teacher_dtype=torch.bfloat16) -> MemReport:
    """Rank 0's sharded KD step (``train/trainer.py``
    ``make_sharded_train_step``) at real geometry on a ``(data, model)``
    mesh, its two groups fake ones of the fake process group: the fp32
    latent student, its AdamW moments and the teacher split over the ranks
    as ``parallel/sharding.py`` ``mesh_layout`` splits them, a global batch
    ``[batch_size, seq_len]``. On ``(1, 1)``: the one-device step."""
    from onebit_tpu_torch.model.bitllama import init_params
    from onebit_tpu_torch.parallel.mesh import create_mesh
    from onebit_tpu_torch.parallel.sharding import mesh_layout, shard_params
    from onebit_tpu_torch.train import trainer as tt
    from onebit_tpu_torch.train.losses import KDConfig

    data, model = mesh_shape
    kd_cfg = kd_cfg or KDConfig()
    train_cfg = train_cfg or tt.TrainConfig()
    label = (f"train ({data}, {model}) B={batch_size} S={seq_len}"
             f"{' remat' if train_cfg.remat else ''}")
    with _FakeRanks(data * model):
        cpu = torch.device("cpu")
        student = init_params(config, mode="latent", dtype=torch.float32,
                              device=cpu)
        teacher = init_params(config, mode="linear", dtype=teacher_dtype,
                              device=cpu)
        ids = torch.zeros((batch_size, seq_len), dtype=torch.long)
        batch = {"input_ids": ids, "labels": ids}
        if data * model == 1:
            state = tt.init_train_state(student, train_cfg)
            step = tt.make_train_step(config, kd_cfg, train_cfg,
                                      compute_dtype=compute_dtype)
        else:
            mesh = create_mesh((data, model), "cpu")
            layout = mesh_layout(student, config, mesh.shape)
            t_layout = mesh_layout(teacher, config, mesh.shape)
            state = tt.init_train_state(
                shard_params(student, mesh, layout), train_cfg)
            teacher = shard_params(teacher, mesh, t_layout)
            step = tt.make_sharded_train_step(
                config, kd_cfg, train_cfg, mesh, layout, t_layout,
                compute_dtype=compute_dtype)
        del student
        return _measure(label, (state.params, state.opt_state.mu,
                                state.opt_state.nu, teacher, batch),
                        lambda: step(state, teacher, batch))


def dry_run_serve(config: BitLlamaConfig, tp: int, *, max_batch: int = 8,
                  max_len: int = 2048, compute_dtype=torch.bfloat16,
                  paged: bool = False, page_size: int = 16) -> MemReport:
    """One decode step (greedy) of a tensor-parallel rank of ``tp``
    (``engine/tp_backend.py`` ``TPServing``) at real geometry: packed
    weights split as ``shard_tp_params`` splits them, the rank's heads of a
    dense KV cache of ``max_batch`` rows of ``max_len`` or of a page pool
    that holds as many; with ``tp`` 1, the single-device step."""
    import numpy as np

    from onebit_tpu_torch.engine.tp_backend import TPServing
    from onebit_tpu_torch.model.bitllama import init_kv_cache, init_params
    from onebit_tpu_torch.model.tp_decode import shard_tp_params
    from onebit_tpu_torch.parallel.mesh import TPGroup

    kind = "paged" if paged else "dense"
    label = f"serve tp={tp} {kind} B={max_batch} T={max_len}"
    with _FakeRanks(tp):
        cpu = torch.device("cpu")
        group = TPGroup(dist.group.WORLD, 0, tp, cpu)
        params = shard_tp_params(
            init_params(config, mode="packed", dtype=compute_dtype,
                        device=cpu), group)
        serving = TPServing(group, config, compute_dtype=compute_dtype)
        nkv = config.num_key_value_heads // tp
        tokens = torch.zeros((max_batch, 1), dtype=torch.long)
        if paged:
            from onebit_tpu_torch.engine.paged import init_paged_kv_cache
            per_row = -(-max_len // page_size)
            cache = init_paged_kv_cache(
                config, max_batch * per_row + 1, page_size,
                dtype=compute_dtype, device=cpu, num_kv_heads=nkv)
            lengths = torch.ones(max_batch, dtype=torch.int32)
            tables = torch.zeros((max_batch, per_row), dtype=torch.int32)
            inputs = (params, cache, tokens, lengths, tables)

            def step():
                return serving.paged_greedy_step(params, cache, tokens,
                                                 lengths, tables)
        else:
            cache = init_kv_cache(config, max_batch, max_len,
                                  dtype=compute_dtype, device=cpu,
                                  num_kv_heads=nkv)
            pos = np.zeros(max_batch, dtype=np.int64)
            active = np.ones(max_batch, dtype=bool)
            inputs = (params, cache, tokens)

            def step():
                return serving.greedy_step(params, cache, tokens, pos,
                                           active)
        return _measure(label, inputs, step)


def analytic_train_bytes(config: BitLlamaConfig,
                         mesh_shape: Tuple[int, int], batch_size: int,
                         seq_len: int, *, compute_dtype=torch.bfloat16,
                         teacher_dtype=torch.bfloat16) -> int:
    """The hand model of one rank's KD step (``memplan.py:221-266`` of the
    JAX package, the same arithmetic): the fp32 latent student, two Adam
    moments over the layers' tree and the teacher, all split over every
    rank, plus one ``[B_local, S, d]`` checkpoint a layer (twice: the
    teacher's layer outputs too) and three fp32 logits tensors of the local
    batch (student, teacher, the KL's softmax)."""
    n_chips = mesh_shape[0] * mesh_shape[1]
    shapes = _tree_bytes(config, torch.float32, teacher_dtype)
    params_b, trainable, teacher_b = shapes
    moments_b = 2 * trainable
    b_local = max(1, batch_size // mesh_shape[0])
    act_itemsize = torch.empty((), dtype=compute_dtype).element_size()
    acts_b = (2 * config.num_hidden_layers * b_local * seq_len *
              config.hidden_size * act_itemsize)
    logits_b = 3 * b_local * seq_len * config.vocab_size * 4
    return (params_b + moments_b + teacher_b) // n_chips + acts_b + logits_b


def _tree_bytes(config: BitLlamaConfig, student_dtype, teacher_dtype):
    """(student bytes, its layers' bytes, teacher bytes) of the latent
    student and the linear teacher, from their shapes alone."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from onebit_tpu_torch.model.bitllama import init_params
    from onebit_tpu_torch.parallel.sharding import named_leaves

    def nbytes(tree, prefix=""):
        return sum(t.numel() * t.element_size()
                   for k, t in named_leaves(tree) if k.startswith(prefix))
    with FakeTensorMode():
        student = init_params(config, mode="latent", dtype=student_dtype,
                              device="cpu")
        teacher = init_params(config, mode="linear", dtype=teacher_dtype,
                              device="cpu")
        return (nbytes(student), nbytes(student, "layers."),
                nbytes(teacher))


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``"4x2"`` -> ``(4, 2)`` (``onebit_tpu/cli.py`` ``_parse_mesh``)."""
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise SystemExit(f"--mesh must be DATAxMODEL (e.g. 4x2), got {spec}")
    return int(parts[0]), int(parts[1])


def config_only(model: Optional[str], ckpt: Optional[str]
                ) -> BitLlamaConfig:
    """The geometry of a dry run: a named model or a checkpoint's
    ``config.json`` (``onebit_tpu/cli.py`` ``_config_only``)."""
    import os
    if model:
        return BitLlamaConfig.named(model)
    if not ckpt:
        raise SystemExit("--dry-compile needs --model NAME or a checkpoint "
                         "whose config.json supplies the geometry")
    return BitLlamaConfig.from_json(os.path.join(ckpt, "config.json"))
