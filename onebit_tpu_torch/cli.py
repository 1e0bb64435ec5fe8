"""Command line of the PyTorch port.

    python -m onebit_tpu_torch eval --ckpt DIR --tokens FILE.npy \\
        [--seqlen 2048] [--batch-size 4] [--limit N] [--vocab-chunk N] \\
        [--expect FILE.json] [--device cuda|cpu]

Port of the ``--tokens`` path of ``onebit_tpu/cli.py`` ``cmd_eval``: the
windowed perplexity of a pre-tokenized stream (``.npy``) under a native
checkpoint (``config.json`` + ``params.npz``), printed as one JSON line,
then checked against pinned numbers with ``--expect``. The other sources
of the JAX command exit nonzero, naming what they wait for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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
    "check_engines": "engine/generate.py, among slice 3's leftovers",
    "decontaminate": "--tasks and tools/decontam/",
}


def _check_expect(results, path: str) -> None:
    """Pinned numbers ``{"metric": {"value": v, "atol": a}, ...}``; keys
    starting with ``_`` are comments. Exits nonzero on any miss. A pinned
    ``engine_check.*`` fails: the engine gate is not ported, and a gate
    that cannot run must not pass."""
    with open(path) as f:
        expected = json.load(f)
    failures = []
    for metric, spec in expected.items():
        if metric.startswith("_"):
            continue
        if metric.split(".")[0] == "engine_check":
            failures.append(f"{metric}: NOT RUN (--check-engines waits for "
                            f"{WAITING['check_engines']})")
            print(failures[-1])
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


def cmd_eval(args) -> None:
    import numpy as np

    from onebit_tpu_torch.ckpt.native import load_native
    from onebit_tpu_torch.eval.ppl import perplexity

    for flag, why in WAITING.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: "
                             f"it waits for {why}")
    if not args.tokens:
        raise SystemExit("eval needs --tokens FILE.npy (a pre-tokenized "
                         "stream)")
    if not os.path.exists(os.path.join(args.ckpt, "params.npz")):
        raise SystemExit(f"{args.ckpt} is not a native checkpoint (config.json"
                         " + params.npz); sharded and reference HF "
                         "checkpoints are not ported yet")
    loaded = load_native(args.ckpt, device=args.device)
    results = {"ppl": perplexity(
        loaded["params"], loaded["config"], np.load(args.tokens),
        seqlen=args.seqlen, batch_size=args.batch_size, limit=args.limit,
        progress=True, vocab_chunk=args.vocab_chunk)}
    print(json.dumps(results, default=float), flush=True)
    if args.expect:
        _check_expect(results, args.expect)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="onebit_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("eval", help="perplexity of a token stream")
    e.add_argument("--ckpt", required=True, help="native checkpoint dir")
    e.add_argument("--tokens", help="pre-tokenized stream .npy for ppl")
    e.add_argument("--seqlen", type=int, default=2048)
    e.add_argument("--batch-size", type=int, default=4)
    e.add_argument("--limit", type=int)
    e.add_argument("--vocab-chunk", type=int, default=None,
                   help="stream the ppl lm_head/CE in vocab chunks of this "
                   "size (online logsumexp)")
    e.add_argument("--expect", help="pinned expected-numbers JSON; exits "
                   "nonzero when any metric misses its tolerance")
    e.add_argument("--device", default="cuda",
                   help="where to run: cuda (default) or cpu")
    for flag in ("corpus", "wikitext", "tasks", "tokenizer",
                 "decontaminate"):
        e.add_argument(f"--{flag}", help="not ported yet")
    e.add_argument("--check-engines", nargs="?", const="all", default=None,
                   help="not ported yet")
    e.set_defaults(fn=cmd_eval)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
