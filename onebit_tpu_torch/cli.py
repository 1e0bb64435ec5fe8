"""Command line of the PyTorch port.

    python -m onebit_tpu_torch build-start-ckpt TEACHER_DIR OUT_DIR \\
        [--method power|nmf] [--num-iters 50] [--device cuda|cpu]
    python -m onebit_tpu_torch train --student DIR --teacher DIR \\
        --tokens BLOCKS.npy [--output-dir out] [--batch-size 4] \\
        [--max-steps N] [KD and optimizer flags] [--device cuda|cpu]
    python -m onebit_tpu_torch convert TRAIN_CKPT OUT_DIR \\
        [--format native|reference] [--device ...]
    python -m onebit_tpu_torch eval --ckpt DIR [--tokens FILE.npy] \\
        [--seqlen 2048] [--batch-size 4] [--limit N] [--vocab-chunk N] \\
        [--check-engines dense,kvq,int4,paged] [--expect FILE.json] \\
        [--device cuda|cpu]
    python -m onebit_tpu_torch generate --ckpt DIR --prompt 1,2,3 \\
        [--max-new-tokens 64] [--greedy] [--temperature 0.95] \\
        [--top-k 50] [--top-p 0.7] [--device cuda|cpu]
    python -m onebit_tpu_torch serve --ckpt DIR [--max-batch 8] \\
        [--max-len 2048] [--max-new-tokens 128] [--block-steps N] \\
        [--pipeline-blocks] [--paged] [--page-size 16] \\
        [--kv-quant int8|int4] [--prefix-cache] [--fuse-decode] \\
        [sampling flags] [--http [PORT]] [--host H] [--device cuda|cpu]

Port of ``onebit_tpu/cli.py``'s pipeline. A checkpoint is a native
directory (``config.json`` + ``params.npz``) or a reference Hugging Face
directory (``ckpt/hf_reader.py``). The commands: the SVID start checkpoint
from a plain teacher, KD training on pre-tokenized blocks (``[N, S]``
``.npy``), packing for inference (native, or the reference's int8 format),
the windowed perplexity of a pre-tokenized stream and the serving engines'
greedy cross-check against ``generate``, printed as one JSON line and
checked against pinned numbers with ``--expect``, generation from a
prompt of comma-separated token ids, and serving: one request a stdin line
of comma-separated ids, or over HTTP (``engine/server.py``). What is not
ported yet (text datasets and tokenizers, sharded checkpoints, beam search,
speculative decoding, ``serve --tp``, ``--dry-compile``) exits nonzero,
naming what it waits for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from onebit_tpu_torch.engine.paged import ENGINE_OPTIONS_WAIT
from onebit_tpu_torch.parallel.mesh import PARALLEL_WAIT
from onebit_tpu_torch.train.data import TEXT_DATASETS_WAIT_FOR

# flag -> what it waits for (ROADMAP.md)
WAITING = {
    "corpus": "eval/datasets.py and a Hugging Face tokenizer "
              "(transformers), which the repository does not hold",
    "wikitext": "a Hugging Face tokenizer (transformers), which the "
                "repository does not hold",
    "tasks": "eval/tasks/* and a Hugging Face tokenizer (transformers), "
             "which the repository does not hold",
    "tokenizer": "a Hugging Face tokenizer (transformers), which the "
                 "repository does not hold",
    "decontaminate": "--tasks and tools/decontam/",
}
# the engine configurations of --check-engines (onebit_tpu/cli.py:214-220)
ENGINE_CHECKS = {
    "dense": {},
    "kvq": dict(quantized_kv=True),
    "int4": dict(quantized_kv="int4"),
    "paged": dict(paged=True, quantized_kv=True, page_size=16),
    "pipelined": dict(block_steps=4, pipeline_blocks=True),
}
BEAM_WAITS_FOR = "engine/beam.py (ROADMAP.md §1 item 4)"


_TEXT = TEXT_DATASETS_WAIT_FOR
_PARALLEL = PARALLEL_WAIT
# train flag -> what it waits for
WAITING_TRAIN = {
    "data": _TEXT, "dataset": _TEXT, "tokenizer": _TEXT,
    "config": "a port of the JAX command's yaml/json argument files",
    "sharded_ckpt": "orbax sharded train states, " + _PARALLEL,
    "dry_compile": "parallel/memplan.py, " + _PARALLEL,
    "model": "--dry-compile", "mesh": "--dry-compile", "hbm_gb":
    "--dry-compile",
}
WAITING_CONVERT = {"sharded": "sharded checkpoints, " + _PARALLEL}
# serve flag -> what it waits for
WAITING_SERVE = {
    "dry_compile": "parallel/memplan.py, " + _PARALLEL,
    "tokenizer": WAITING["tokenizer"],
    "draft": "speculative decoding, " + ENGINE_OPTIONS_WAIT,
    "tp": "a launcher of the tensor-parallel ranks behind one front end "
          "(ROADMAP.md §1 item 4)",
}


def _check_expect(results, path: str, check_engines: bool) -> None:
    """Pinned numbers ``{"metric": {"value": v, "atol": a}, ...}``; keys
    starting with ``_`` are comments. Exits nonzero on any miss. A pinned
    ``engine_check.*`` is SKIPPED without ``--check-engines`` (the gate is
    opt-in) and checked with it (onebit_tpu/cli.py:359-392)."""
    with open(path) as f:
        expected = json.load(f)
    failures = []
    for metric, spec in expected.items():
        if metric.startswith("_"):
            continue
        if metric.split(".")[0] == "engine_check" and not check_engines:
            print(f"{metric}: SKIPPED (pass --check-engines to assert the "
                  "serving-engine gate)")
            continue
        got = results
        for part in metric.split("."):
            got = got.get(part) if isinstance(got, dict) else None
            if got is None:
                break
        atol = float(spec.get("atol", 0.1))
        if got is None:
            failures.append(f"{metric}: MISSING (wanted "
                            f"{spec['value']}±{atol})")
            continue
        ok = abs(float(got) - float(spec["value"])) <= atol
        line = (f"{metric}: got {float(got):.4f}, want "
                f"{spec['value']}±{atol} -> {'PASS' if ok else 'FAIL'}")
        print(line)
        if not ok:
            failures.append(line)
    if failures:
        raise SystemExit("expectation failures:\n" + "\n".join(failures))


def _load_any_ckpt(path: str, device):
    """A native checkpoint (``params.npz``) or a reference Hugging Face
    directory (onebit_tpu/cli.py:25-35); a sharded one exits nonzero."""
    meta = os.path.join(path, "metadata.json")
    if os.path.exists(meta):
        with open(meta) as f:
            if json.load(f).get("format") == "onebit-sharded":
                raise SystemExit(f"{path} is a sharded checkpoint, which is "
                                 f"not ported yet: it waits for {_PARALLEL}")
    if os.path.exists(os.path.join(path, "params.npz")):
        from onebit_tpu_torch.ckpt.native import load_native
        return load_native(path, device=device)
    from onebit_tpu_torch.ckpt.hf_reader import load_reference_checkpoint
    return load_reference_checkpoint(path, device=device)


def cmd_build_start(args) -> None:
    from onebit_tpu_torch.ckpt.native import save_native
    from onebit_tpu_torch.core.build_start import build_start_params

    loaded = _load_any_ckpt(args.teacher, args.device)
    start = build_start_params(loaded["params"], method=args.method,
                               num_iters=args.num_iters)
    save_native(args.out, loaded["config"], start)
    print(f"start checkpoint written to {args.out}")


def cmd_convert(args) -> None:
    from onebit_tpu_torch.ckpt.native import (export_reference_int8,
                                              save_native)
    from onebit_tpu_torch.model.bitllama import pack_model_params

    if args.format in WAITING_CONVERT:
        raise SystemExit(f"--format {args.format} is not ported yet: it "
                         f"waits for {WAITING_CONVERT[args.format]}")
    loaded = _load_any_ckpt(args.ckpt, args.device)
    write = save_native if args.format == "native" else export_reference_int8
    write(args.out, loaded["config"], pack_model_params(loaded["params"]))
    print(f"packed inference checkpoint ({args.format}) -> {args.out}")


def cmd_train(args) -> None:
    import numpy as np

    from onebit_tpu_torch.train.losses import KDConfig
    from onebit_tpu_torch.train.run_kd import KDRunConfig, run_kd
    from onebit_tpu_torch.train.trainer import TrainConfig
    from onebit_tpu_torch.train.validate import validate_kd

    for flag, why in WAITING_TRAIN.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: "
                             f"it waits for {why}")
    if not (args.student and args.teacher and args.tokens):
        raise SystemExit("train needs --student DIR, --teacher DIR and "
                         "--tokens BLOCKS.npy (pre-tokenized [N, S] blocks)")
    student = _load_any_ckpt(args.student, args.device)
    teacher = _load_any_ckpt(args.teacher, args.device)
    config = student["config"]
    blocks = np.load(args.tokens)
    print(f"dataset: {blocks.shape[0]} blocks x {blocks.shape[1]}")
    kd_cfg = KDConfig(kd_alpha=args.kd_alpha, kd_beta=args.kd_beta,
                      kd_gamma=args.kd_gamma,
                      kd_loss_scale=args.kd_loss_scale)
    train_cfg = TrainConfig(learning_rate=args.learning_rate,
                            warmup_steps=args.warmup_steps,
                            weight_decay=args.weight_decay,
                            remat=args.remat)
    run_cfg = KDRunConfig(output_dir=args.output_dir,
                          batch_size=args.batch_size,
                          num_epochs=args.num_epochs,
                          max_steps=args.max_steps,
                          save_steps=args.save_steps,
                          save_total_limit=args.save_total_limit,
                          resume_from=args.resume_from)
    # student-vs-teacher cross-checks need both configs; run_kd validates
    # the rest (reference get_train_args, core.py:81-215)
    validate_kd(kd_cfg, config, teacher["config"])
    run_kd(config, student["params"], teacher["params"], blocks,
           kd_cfg=kd_cfg, train_cfg=train_cfg, run_cfg=run_cfg)


def _engine_consistency_check(loaded, configs, device, *, max_len: int = 256,
                              n_new: int = 6) -> dict:
    """Greedy cross-check of the serving engines against ``generate``
    (onebit_tpu/cli.py:189-240): the bf16 dense engine, one step a call
    and in pipelined blocks, must give ``generate``'s tokens exactly; the
    quantized ones (int8 KT, int4 KT, paged int8) its FIRST token exactly
    (every engine's prefill attends in full precision) and only in-vocab
    tokens. Returns ``{"ok": 1/0,
    "<config>": 1/0, ...}`` so that ``--expect`` can pin
    ``engine_check.ok``."""
    import numpy as np

    from onebit_tpu_torch.engine.batching import ContinuousBatchingEngine
    from onebit_tpu_torch.engine.generate import generate
    from onebit_tpu_torch.engine.sampler import SamplingConfig

    params, config = loaded["params"], loaded["config"]
    rng = np.random.default_rng(0)
    hi = min(config.vocab_size, 1000)
    prompts = [rng.integers(1, hi, n).tolist() for n in (4, 7, 3)]
    greedy = SamplingConfig(greedy=True)
    want = generate(params, config, prompts, max_new_tokens=n_new,
                    sampling=greedy)
    out = {}
    for name in configs:
        eng = ContinuousBatchingEngine(
            params, config, max_batch=2, max_len=max_len, sampling=greedy,
            device=device, **ENGINE_CHECKS[name])
        uids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
        got = eng.run()
        got = [got[u] for u in uids]
        if name in ("dense", "pipelined"):
            good = got == want
        else:
            good = all(g and g[0] == w[0]
                       and all(0 <= t < config.vocab_size for t in g)
                       for g, w in zip(got, want))
        out[name] = float(good)
        print(f"engine check [{name}]: {'OK' if good else 'MISMATCH'}")
    out["ok"] = min(out.values()) if out else 0.0
    return out


def _engine_configs(spec: str):
    """The configurations of ``--check-engines`` (``all`` or a comma list);
    exits nonzero before anything runs when one is unknown."""
    names = (["dense", "pipelined", "kvq", "int4", "paged"] if spec == "all"
             else [c.strip() for c in spec.split(",") if c.strip()])
    unknown = [n for n in names if n not in ENGINE_CHECKS]
    if unknown:
        raise SystemExit(f"--check-engines: unknown configurations {unknown} "
                         f"(known: {sorted(ENGINE_CHECKS)})")
    return names


def cmd_eval(args) -> None:
    import numpy as np

    from onebit_tpu_torch.eval.ppl import perplexity

    for flag, why in WAITING.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: "
                             f"it waits for {why}")
    configs = _engine_configs(args.check_engines) if args.check_engines \
        else None
    if not (args.tokens or configs):
        raise SystemExit("eval needs --tokens FILE.npy (a pre-tokenized "
                         "stream) or --check-engines")
    loaded = _load_any_ckpt(args.ckpt, args.device)
    results = {}
    if configs:
        results["engine_check"] = _engine_consistency_check(
            loaded, configs, args.device)
    if args.tokens:
        results["ppl"] = perplexity(
            loaded["params"], loaded["config"], np.load(args.tokens),
            seqlen=args.seqlen, batch_size=args.batch_size, limit=args.limit,
            progress=True, vocab_chunk=args.vocab_chunk)
    print(json.dumps(results, default=float), flush=True)
    if args.expect:
        _check_expect(results, args.expect, bool(configs))


def cmd_generate(args) -> None:
    from onebit_tpu_torch.engine.generate import generate
    from onebit_tpu_torch.engine.sampler import SamplingConfig

    if args.tokenizer:
        raise SystemExit("--tokenizer is not ported yet: it waits for "
                         f"{WAITING['tokenizer']}")
    if args.num_beams > 1:
        raise SystemExit("--num-beams > 1 is not ported yet: it waits for "
                         f"{BEAM_WAITS_FOR}")
    prompt = [int(t) for t in args.prompt.split(",")]
    loaded = _load_any_ckpt(args.ckpt, args.device)
    sampling = SamplingConfig(greedy=args.greedy,
                              temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    out = generate(loaded["params"], loaded["config"], [prompt],
                   max_new_tokens=args.max_new_tokens, sampling=sampling)[0]
    print(",".join(map(str, out)))


def cmd_serve(args) -> None:
    """Serving over the continuous-batching engine (onebit_tpu/cli.py:
    425-518): one prompt of comma-separated ids a stdin line, completions
    printed when all are done; ``--http PORT``: an HTTP server with POST
    /generate (sync and ndjson streaming), GET /metrics and GET /health
    (``engine/server.py``)."""
    import time

    from onebit_tpu_torch.engine.batching import ContinuousBatchingEngine
    from onebit_tpu_torch.engine.sampler import SamplingConfig
    from onebit_tpu_torch.engine.server import EngineServer

    def wait(flag, why):
        raise SystemExit(f"--{flag} is not ported yet: it waits for {why}")

    if args.dry_compile:
        wait("dry-compile", WAITING_SERVE["dry_compile"])
    if args.tokenizer:
        wait("tokenizer", WAITING_SERVE["tokenizer"])
    if not args.paged and args.prefix_cache:
        raise SystemExit("--prefix-cache requires --paged")
    if not args.paged and args.kv_quant == "fp8":
        raise SystemExit("--kv-quant fp8 requires --paged (dense "
                         "quantized serving uses the int8 transposed-K "
                         "fused kernel; fp8 pools are paged-only)")
    if args.paged and args.kv_quant == "int4":
        raise SystemExit("--kv-quant int4 is dense-engine only (no int4 "
                         "paged pools); drop --paged")
    if args.kv_quant == "fp8":
        raise SystemExit("--kv-quant fp8 is not ported yet: fp8 pages wait "
                         f"for {ENGINE_OPTIONS_WAIT}")
    if args.draft:
        wait("draft", WAITING_SERVE["draft"])
    if args.tp > 1:
        wait("tp", WAITING_SERVE["tp"])
    if args.prefill_chunk and not args.paged:
        wait("prefill-chunk without --paged", ENGINE_OPTIONS_WAIT)
    if not args.ckpt:
        raise SystemExit("serve needs --ckpt DIR")
    loaded = _load_any_ckpt(args.ckpt, args.device)
    config, params = loaded["config"], loaded["params"]
    if args.fuse_decode:
        from onebit_tpu_torch.model.bitllama import fuse_for_decode
        params = fuse_for_decode(params, config)
    sampling = SamplingConfig(greedy=args.greedy,
                              temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    eng = ContinuousBatchingEngine(
        params, config, max_batch=args.max_batch, max_len=args.max_len,
        sampling=sampling, block_steps=args.block_steps, paged=args.paged,
        quantized_kv=args.kv_quant or False, page_size=args.page_size,
        prefix_cache=args.prefix_cache,
        prefill_chunk_size=args.prefill_chunk,
        pipeline_blocks=args.pipeline_blocks, device=args.device)
    if args.http is not None:
        server = EngineServer(eng)
        port = server.start(host=args.host, port=args.http)
        print(f"serving on http://{args.host}:{port} "
              "(POST /generate, GET /metrics)", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.stop()
        return
    prompts = {}
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        uid = eng.add_request([int(t) for t in line.split(",")],
                              max_new_tokens=args.max_new_tokens)
        prompts[uid] = line
    out = eng.run()
    for uid in sorted(out):
        print(json.dumps({"prompt": prompts[uid],
                          "completion": ",".join(map(str, out[uid]))}))


def _device_flag(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where to run: cuda (default) or cpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="onebit_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-start-ckpt", help="SVID init from a teacher")
    b.add_argument("teacher", help="native checkpoint of the plain teacher")
    b.add_argument("out")
    b.add_argument("--method", default="power", choices=["power", "nmf"])
    b.add_argument("--num-iters", type=int, default=50)
    _device_flag(b)
    b.set_defaults(fn=cmd_build_start)

    c = sub.add_parser("convert", help="pack a train checkpoint for "
                       "inference")
    c.add_argument("ckpt")
    c.add_argument("out")
    c.add_argument("--format", default="native",
                   choices=["native", "reference", "sharded"])
    _device_flag(c)
    c.set_defaults(fn=cmd_convert)

    t = sub.add_parser("train", help="KD training")
    t.add_argument("--student", help="native start checkpoint (latent)")
    t.add_argument("--teacher", help="native teacher checkpoint")
    t.add_argument("--tokens", help="pre-tokenized blocks .npy [N, S]")
    t.add_argument("--output-dir", default="out")
    t.add_argument("--batch-size", type=int, default=4)
    t.add_argument("--num-epochs", type=int, default=50)
    t.add_argument("--max-steps", type=int)
    t.add_argument("--save-steps", type=int, default=5000)
    t.add_argument("--save-total-limit", type=int, default=None,
                   help="keep only the newest N checkpoints (HF Trainer "
                   "save_total_limit)")
    t.add_argument("--resume-from", help="a checkpoint-N directory")
    t.add_argument("--learning-rate", type=float, default=4e-4)
    t.add_argument("--warmup-steps", type=int, default=500)
    t.add_argument("--weight-decay", type=float, default=0.01)
    t.add_argument("--kd-alpha", type=float, default=1.0)
    t.add_argument("--kd-beta", type=float, default=1.0)
    t.add_argument("--kd-gamma", type=float, default=0.0)
    t.add_argument("--kd-loss-scale", type=float, default=0.01)
    t.add_argument("--remat", action="store_true",
                   help="recompute decoder layers in the backward pass "
                   "(gradient checkpointing, reference core.py:254-263)")
    _device_flag(t)
    for flag in ("data", "dataset", "tokenizer", "config", "model",
                 "mesh", "hbm_gb"):
        t.add_argument(f"--{flag.replace('_', '-')}", help="not ported yet")
    t.add_argument("--cutoff-len", type=int, default=2048,
                   help="block length of text datasets (not ported yet)")
    for flag in ("sharded_ckpt", "dry_compile"):
        t.add_argument(f"--{flag.replace('_', '-')}", action="store_true",
                       help="not ported yet")
    t.set_defaults(fn=cmd_train)
    e = sub.add_parser("eval", help="perplexity of a token stream")
    e.add_argument("--ckpt", required=True, help="native or reference "
                   "checkpoint dir")
    e.add_argument("--tokens", help="pre-tokenized stream .npy for ppl")
    e.add_argument("--seqlen", type=int, default=2048)
    e.add_argument("--batch-size", type=int, default=4)
    e.add_argument("--limit", type=int)
    e.add_argument("--vocab-chunk", type=int, default=None,
                   help="stream the ppl lm_head/CE in vocab chunks of this "
                   "size (online logsumexp)")
    e.add_argument("--expect", help="pinned expected-numbers JSON; exits "
                   "nonzero when any metric misses its tolerance")
    _device_flag(e)
    for flag in ("corpus", "wikitext", "tasks", "tokenizer",
                 "decontaminate"):
        e.add_argument(f"--{flag}", help="not ported yet")
    e.add_argument("--check-engines", nargs="?", const="all", default=None,
                   help="greedy cross-check of the serving engines against "
                   "generate: a comma list of dense, pipelined, kvq, int4, "
                   "paged (the bare flag: all); adds engine_check.* to the "
                   "results")
    e.set_defaults(fn=cmd_eval)

    g = sub.add_parser("generate", help="generation from token ids")
    g.add_argument("--ckpt", required=True, help="native or reference "
                   "checkpoint dir")
    g.add_argument("--prompt", required=True,
                   help="comma-separated token ids")
    g.add_argument("--tokenizer", help="not ported yet")
    g.add_argument("--max-new-tokens", type=int, default=64)
    g.add_argument("--greedy", action="store_true")
    g.add_argument("--num-beams", type=int, default=1,
                   help="beam search above 1 (not ported yet)")
    g.add_argument("--temperature", type=float, default=0.95)
    g.add_argument("--top-k", type=int, default=50)
    g.add_argument("--top-p", type=float, default=0.7)
    _device_flag(g)
    g.set_defaults(fn=cmd_generate)

    sv = sub.add_parser("serve", help="continuous-batching serving loop "
                        "(prompts of token ids on stdin, or --http)")
    sv.add_argument("--ckpt", help="native or reference checkpoint dir")
    sv.add_argument("--tokenizer", help="not ported yet")
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--max-len", type=int, default=2048)
    sv.add_argument("--max-new-tokens", type=int, default=128)
    sv.add_argument("--greedy", action="store_true")
    sv.add_argument("--temperature", type=float, default=0.95)
    sv.add_argument("--top-k", type=int, default=50)
    sv.add_argument("--top-p", type=float, default=0.7)
    sv.add_argument("--http", type=int, nargs="?", const=8000,
                    help="serve over HTTP on this port (default 8000; 0: "
                    "any free port)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--block-steps", type=int, default=1,
                    help="decode tokens a row per block (on the card one "
                    "CUDA graph a block)")
    sv.add_argument("--pipeline-blocks", action="store_true",
                    help="dispatch block N+1 from block N's device finals "
                    "before reading block N's tokens (with --block-steps "
                    "> 1; the same tokens)")
    sv.add_argument("--fuse-decode", action="store_true",
                    help="fuse the q/k/v and gate/up projections for decode")
    sv.add_argument("--paged", action="store_true",
                    help="paged KV cache (page tables over a page pool)")
    sv.add_argument("--kv-quant", choices=["int8", "fp8", "int4"],
                    default=None,
                    help="quantized KV cache: with --paged int8 pages (fp8 "
                    "not ported yet); without, the int8 or int4 "
                    "transposed-K pools of the fused append+attend kernels")
    sv.add_argument("--page-size", type=int, default=16)
    sv.add_argument("--prefix-cache", action="store_true",
                    help="share full prompt pages between requests "
                    "(requires --paged)")
    sv.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill size (with --paged)")
    sv.add_argument("--draft", help="not ported yet")
    sv.add_argument("--tp", type=int, default=1, help="not ported yet")
    sv.add_argument("--dry-compile", action="store_true",
                    help="not ported yet")
    _device_flag(sv)
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
