"""Command line of the PyTorch port.

    python -m onebit_tpu_torch build-start-ckpt TEACHER_DIR OUT_DIR \\
        [--method power|nmf] [--num-iters 50] [--device cuda|cpu]
    python -m onebit_tpu_torch train --student DIR --teacher DIR \\
        (--tokens BLOCKS.npy | --data DIR --dataset NAME [--tokenizer TOK] \\
        [--cutoff-len 2048]) [--output-dir out] [--batch-size 4] \\
        [--max-steps N] [KD and optimizer flags] [--device cuda|cpu]
    python -m onebit_tpu_torch train --config FILE.yaml|FILE.json [flags]
    python -m onebit_tpu_torch train --dry-compile --model NAME \\
        [--mesh 4x2] [--batch-size 8] [--cutoff-len 2048] [--hbm-gb 80]
    python -m onebit_tpu_torch convert TRAIN_CKPT OUT_DIR \\
        [--format native|reference|sharded] [--device ...]
    python -m onebit_tpu_torch build-draft STUDENT_DIR OUT_DIR \\
        [--num-layers 2] [--strategy spread|first] [--for-training] \\
        [--device ...]
    python -m onebit_tpu_torch eval --ckpt DIR [--tokens FILE.npy] \\
        [--corpus wikitext2,c4 [--corpus-source PATH]] [--wikitext FILE] \\
        [--tasks piqa,arc_*,hendrycksTest [--task-source DIR] \\
        [--num-fewshot K] [--decontaminate TRAIN.txt]] [--tokenizer TOK] \\
        [--seqlen 2048] [--batch-size 4] [--limit N] [--vocab-chunk N] \\
        [--check-engines dense,kvq,int4,paged] [--expect FILE.json] \\
        [--device cuda|cpu]
    python -m onebit_tpu_torch generate --ckpt DIR --prompt 1,2,3 \\
        [--tokenizer TOK (--prompt then is text)] \\
        [--max-new-tokens 64] [--greedy] [--temperature 0.95] \\
        [--top-k 50] [--top-p 0.7] [--num-beams K [--length-penalty 1.0]] \\
        [--device cuda|cpu]
    python -m onebit_tpu_torch serve --ckpt DIR [--tokenizer TOK] \\
        [--max-batch 8] \\
        [--max-len 2048] [--max-new-tokens 128] [--block-steps N] \\
        [--pipeline-blocks] [--paged] [--page-size 16] \\
        [--kv-quant int8|fp8|int4] [--prefix-cache] [--prefill-chunk N] \\
        [--fuse-decode] [--draft DIR [--n-draft 4]] \\
        [--tp N [--tp-backend nccl|gloo]] \\
        [sampling flags] [--http [PORT]] [--host H] [--device cuda|cpu]
    python -m onebit_tpu_torch serve --dry-compile --model NAME --tp N \\
        [--max-batch 8] [--max-len 2048] [--paged] [--hbm-gb 80]

``train``, ``eval`` and ``serve`` take the multi-host flags
(``onebit_tpu/cli.py:525-562``): run the same command in every process
with ``--coordinator HOST:PORT --num-processes N --process-id I``, or under
torchrun with ``--distributed``. Each process is one rank, on
``cuda:{rank % device_count}`` (or the CPU with ``--device cpu``), and
joins the group before it computes anything (``parallel/mesh.py``
``initialize_distributed``): ``train`` trains sharded over the N ranks
on JAX's default ``(data, model)`` mesh, ``(gcd(N, batch), N // gcd)``
(nccl under ``--device cuda``, a card a rank; gloo on the CPU),
``eval`` runs in every rank as one process does, and ``serve --tp N``
runs rank ``--process-id`` of its N tensor-parallel ranks, rank 0 the front
end.

Port of ``onebit_tpu/cli.py``'s pipeline. A checkpoint is a native
directory (``config.json`` + ``params.npz``) or a reference Hugging Face
directory (``ckpt/hf_reader.py``). The commands: the SVID start checkpoint
from a plain teacher, KD training on pre-tokenized blocks (``[N, S]``
``.npy``) or on a registered text dataset, packing for inference (native,
or the reference's int8 format), evaluation (the windowed perplexity of a
pre-tokenized stream or of named corpora, rolling WikiText perplexity,
the zero-shot task registry, and the serving engines' greedy cross-check
against ``generate``), printed as one JSON line and checked against
pinned numbers with ``--expect``, generation from a prompt (sampled,
greedy or by beam search), the draft model of speculative decoding sliced
from a student, and serving: one request a stdin line, or over HTTP
(``engine/server.py``), with a draft model if asked, on one device or on
tensor-parallel ranks behind one front end (``engine/tp_serve.py``). Without
``--tokenizer`` prompts and completions are comma-separated token ids.
A tokenizer is ``AutoTokenizer.from_pretrained(--tokenizer)`` (for eval
and train, the checkpoint's own directory by default), imported only
where a command needs one. ``train --config`` reads the train flags from
a yaml or json file (its values override the command line's). Every
``--ckpt`` (and ``--student``, ``--teacher``, ``--draft``) may also be the
port's sharded checkpoint (``ckpt/sharded.py``, written by ``convert
--format sharded``); the JAX package's orbax directories exit nonzero,
saying why. ``--dry-compile`` prints one rank's memory plan
(``parallel/memplan.py``) and exits nonzero when it passes ``--hbm-gb``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the engine configurations of --check-engines (onebit_tpu/cli.py:214-220)
ENGINE_CHECKS = {
    "dense": {},
    "kvq": dict(quantized_kv=True),
    "int4": dict(quantized_kv="int4"),
    "paged": dict(paged=True, quantized_kv=True, page_size=16),
    "pipelined": dict(block_steps=4, pipeline_blocks=True),
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
    """The port's sharded checkpoint, a native one (``params.npz``) or a
    reference Hugging Face directory (onebit_tpu/cli.py:25-35), whole on
    ``device``; a JAX orbax directory exits nonzero, saying why."""
    from onebit_tpu_torch.ckpt.sharded import (check_not_orbax,
                                               is_sharded_ckpt, load_sharded)
    check_not_orbax(path)
    if is_sharded_ckpt(path):
        return load_sharded(path, device=device)
    if os.path.exists(os.path.join(path, "params.npz")):
        from onebit_tpu_torch.ckpt.native import load_native
        return load_native(path, device=device)
    from onebit_tpu_torch.ckpt.hf_reader import load_reference_checkpoint
    return load_reference_checkpoint(path, device=device)


def _load_tokenizer(path: str):
    """``AutoTokenizer.from_pretrained(path)`` (onebit_tpu/cli.py:159-160);
    exits nonzero, naming the path, when no tokenizer loads from it."""
    from transformers import AutoTokenizer
    try:
        return AutoTokenizer.from_pretrained(path)
    except Exception as e:   # noqa: BLE001 - any failure: say where
        raise SystemExit(f"no tokenizer could be loaded from {path}: {e}")


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

    from onebit_tpu_torch.ckpt.sharded import save_sharded

    loaded = _load_any_ckpt(args.ckpt, args.device)
    write = {"native": save_native, "reference": export_reference_int8,
             "sharded": save_sharded}[args.format]
    write(args.out, loaded["config"], pack_model_params(loaded["params"]))
    print(f"packed inference checkpoint ({args.format}) -> {args.out}")


def cmd_build_draft(args) -> None:
    """Slice a shallow draft for speculative decoding from a student
    checkpoint (onebit_tpu/cli.py:65-77, ``train/draft.py``); distill it
    with ``train --student OUT --teacher STUDENT`` before serving it."""
    from onebit_tpu_torch.ckpt.native import save_native
    from onebit_tpu_torch.train.draft import build_draft

    loaded = _load_any_ckpt(args.student, args.device)
    d_config, d_params = build_draft(
        loaded["params"], loaded["config"], args.num_layers,
        strategy=args.strategy, for_training=args.for_training)
    save_native(args.out, d_config, d_params)
    print(f"{args.num_layers}-layer draft ({args.strategy}) -> {args.out}")


def _kd_config(args):
    from onebit_tpu_torch.train.losses import KDConfig
    return KDConfig(kd_alpha=args.kd_alpha, kd_beta=args.kd_beta,
                    kd_gamma=args.kd_gamma, kd_loss_scale=args.kd_loss_scale)


def _report(report, hbm_gb) -> None:
    """Print a memory plan; exit nonzero, with its accounting, past
    ``hbm_gb``."""
    print(report, flush=True)
    if hbm_gb:
        try:
            report.check(hbm_gb)
        except MemoryError as e:
            raise SystemExit(str(e))
        print(f"fits the {hbm_gb:g} GiB/card budget")


def _dry_compile_train(args) -> None:
    """One rank's sharded KD step at the geometry of ``--model`` (or the
    student's config.json) on the ``(data, model)`` mesh ``--mesh``, on
    fake tensors (``parallel/memplan.py``), with the flags' KD terms and
    ``--remat``: no weights, no card."""
    from onebit_tpu_torch.parallel.memplan import (config_only,
                                                   dry_run_train, parse_mesh)
    from onebit_tpu_torch.train.trainer import TrainConfig
    mesh = parse_mesh(args.mesh)
    config = config_only(args.model, args.student)
    try:
        report = dry_run_train(config, mesh, args.batch_size,
                               args.cutoff_len, kd_cfg=_kd_config(args),
                               train_cfg=TrainConfig(remat=args.remat))
    except ValueError as e:
        raise SystemExit(str(e))
    _report(report, args.hbm_gb)


def cmd_train(args) -> None:
    import numpy as np

    from onebit_tpu_torch.train.data import load_texts, prepare_kd_dataset
    from onebit_tpu_torch.train.run_kd import KDRunConfig, run_kd
    from onebit_tpu_torch.train.trainer import TrainConfig
    from onebit_tpu_torch.train.validate import validate_kd

    if args.dry_compile:
        _dry_compile_train(args)
        return
    if not (args.tokens or (args.data and args.dataset)):
        raise SystemExit("train needs --tokens BLOCKS.npy (pre-tokenized "
                         "[N, S] blocks) or --data DIR --dataset NAME (a "
                         "registered text dataset)")
    # in a group every rank loads the checkpoints on the host and trains
    # its shards on its device (run_kd)
    where = "cpu" if _world() > 1 else args.device
    student = _load_any_ckpt(args.student, where)
    teacher = _load_any_ckpt(args.teacher, where)
    config = student["config"]
    if args.tokens:
        blocks = np.load(args.tokens)
    else:
        # onebit_tpu/cli.py:156-163: the teacher's tokenizer by default
        tok = _load_tokenizer(args.tokenizer or args.teacher)
        texts = load_texts(args.data, args.dataset)
        blocks = prepare_kd_dataset(
            texts, lambda s: tok(s)["input_ids"], cutoff_len=args.cutoff_len,
            eos_id=config.eos_token_id)
    print(f"dataset: {blocks.shape[0]} blocks x {blocks.shape[1]}")
    kd_cfg = _kd_config(args)
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
                          sharded_ckpt=args.sharded_ckpt,
                          resume_from=args.resume_from)
    # student-vs-teacher cross-checks need both configs; run_kd validates
    # the rest (reference get_train_args, core.py:81-215)
    validate_kd(kd_cfg, config, teacher["config"])
    run_kd(config, student["params"], teacher["params"], blocks,
           kd_cfg=kd_cfg, train_cfg=train_cfg, run_cfg=run_cfg,
           device=args.device)


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


def _eval_tasks(args, loaded, tokenizer) -> dict:
    """``--tasks`` (onebit_tpu/cli.py:300-355): comma-separated names and
    fnmatch patterns over the registry; ``hendrycksTest`` is every MMLU
    subject. Docs come from ``--task-source DIR`` (local files,
    ``DocTask.from_source``; with a training split when ``--num-fewshot``
    > 0) or else from the Hugging Face hub. Prints ``make_table``; returns
    the results, with ``mmlu`` aggregated over the subjects run."""
    from onebit_tpu_torch.eval.tasks.base import evaluate_tasks, make_table
    from onebit_tpu_torch.eval.tasks.mmlu import (SUBJECTS, MMLUSubject,
                                                  aggregate_mmlu)
    from onebit_tpu_torch.eval.tasks.registry import (TASK_REGISTRY,
                                                      pattern_match)

    names = []
    for pat in (n.strip() for n in args.tasks.split(",")):
        if any(c in pat for c in "*?["):
            names.extend(n for n in pattern_match([pat]) if n not in names)
        elif pat not in names:
            names.append(pat)
    tasks = []
    for name in names:
        if name == "hendrycksTest":
            for subject in SUBJECTS:
                if args.task_source:
                    from onebit_tpu_torch.eval.task_source import load_split
                    rows = load_split(args.task_source,
                                      f"hendrycksTest-{subject}", "test")
                else:
                    import datasets
                    rows = list(datasets.load_dataset(
                        "cais/mmlu", subject, split="test"))
                tasks.append(MMLUSubject(rows, subject))
        elif args.task_source:
            tasks.append(TASK_REGISTRY[name].from_source(
                args.task_source, name, with_train=args.num_fewshot > 0))
        else:
            tasks.append(TASK_REGISTRY[name].from_datasets())
    decontam = None
    if args.decontaminate:
        # training text to 13-gram-scan against each task's
        # decontamination queries (reference evaluator.py:215-221)
        with open(args.decontaminate) as f:
            decontam = f.read()
    results = evaluate_tasks(
        loaded["params"], loaded["config"], tasks,
        lambda s: tokenizer(s, add_special_tokens=False)["input_ids"],
        batch_size=args.batch_size, limit=args.limit,
        num_fewshot=args.num_fewshot, detokenize=tokenizer.decode,
        decontamination_ngrams=decontam)
    print(make_table(results), flush=True)
    mmlu = aggregate_mmlu(results)
    if mmlu:
        results["mmlu"] = mmlu
    return results


def cmd_eval(args) -> None:
    import numpy as np

    from onebit_tpu_torch.eval.ppl import perplexity

    configs = _engine_configs(args.check_engines) if args.check_engines \
        else None
    if not (args.tokens or configs or args.corpus or args.wikitext
            or args.tasks):
        raise SystemExit("eval needs --tokens FILE.npy (a pre-tokenized "
                         "stream), --corpus, --wikitext, --tasks or "
                         "--check-engines")
    loaded = _load_any_ckpt(args.ckpt, _rank_device(args))
    params, config = loaded["params"], loaded["config"]
    results = {}
    if configs:
        results["engine_check"] = _engine_consistency_check(
            loaded, configs, _rank_device(args))
    if args.tokens:
        results["ppl"] = perplexity(
            params, config, np.load(args.tokens), seqlen=args.seqlen,
            batch_size=args.batch_size, limit=args.limit, progress=True,
            vocab_chunk=args.vocab_chunk)
    tok = None
    if args.corpus or args.wikitext or args.tasks:
        tok = _load_tokenizer(args.tokenizer or args.ckpt)

        def tokenize(s):
            return tok(s, add_special_tokens=False)["input_ids"]
    if args.corpus:
        # the real-checkpoint parity path (onebit_tpu/cli.py:261-285)
        from onebit_tpu_torch.eval.datasets import get_eval_tokens
        for name in (n.strip() for n in args.corpus.split(",")):
            stream = get_eval_tokens(name, tokenize,
                                     source=args.corpus_source,
                                     seqlen=args.seqlen)
            if stream is None:
                print(f"{name}: no eval stream defined (reference parity)")
                continue
            results[f"ppl_{name}"] = perplexity(
                params, config, stream, seqlen=args.seqlen,
                batch_size=args.batch_size, limit=args.limit, progress=True,
                vocab_chunk=args.vocab_chunk)
    if args.wikitext:
        from onebit_tpu_torch.eval.tasks.wikitext import evaluate_wikitext
        with open(args.wikitext) as f:
            pages = f.read().split("\n\n")
        results["wikitext"] = evaluate_wikitext(
            params, config, pages, tokenize, batch_size=args.batch_size)
    if args.tasks:
        results.update(_eval_tasks(args, loaded, tok))
    print(json.dumps(results, default=float), flush=True)
    if args.expect:
        _check_expect(results, args.expect, bool(configs))


def cmd_generate(args) -> None:
    from onebit_tpu_torch.engine.beam import beam_generate
    from onebit_tpu_torch.engine.generate import generate
    from onebit_tpu_torch.engine.sampler import SamplingConfig

    loaded = _load_any_ckpt(args.ckpt, args.device)
    if args.tokenizer:
        # onebit_tpu/cli.py:400-420: the prompt is text, the output too
        tok = _load_tokenizer(args.tokenizer)
        prompt = tok(args.prompt)["input_ids"]
    else:
        prompt = [int(t) for t in args.prompt.split(",")]
    if args.num_beams > 1:
        # the best hypothesis (onebit_tpu/cli.py:406-410)
        out = beam_generate(loaded["params"], loaded["config"], [prompt],
                            num_beams=args.num_beams,
                            max_new_tokens=args.max_new_tokens,
                            length_penalty=args.length_penalty)[0][0][0]
    else:
        sampling = SamplingConfig(greedy=args.greedy,
                                  temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p)
        out = generate(loaded["params"], loaded["config"], [prompt],
                       max_new_tokens=args.max_new_tokens,
                       sampling=sampling)[0]
    print(tok.decode(out) if args.tokenizer else ",".join(map(str, out)))


def cmd_serve(args) -> None:
    """Serving over the continuous-batching engine (onebit_tpu/cli.py:
    425-518): one prompt a stdin line (comma-separated ids, or text with
    ``--tokenizer``), completions printed when all are done; ``--http
    PORT``: an HTTP server with POST /generate (sync and ndjson streaming;
    ``text`` bodies with ``--tokenizer``), GET /metrics and GET /health
    (``engine/server.py``). ``--tp N``: N rank processes on this host
    behind one front end, rank 0 (``engine/tp_serve.py``); with the
    multi-host flags this process is rank ``--process-id`` of them.
    ``--dry-compile``: one rank's decode step's memory plan
    (``parallel/memplan.py``)."""
    if args.dry_compile:
        from onebit_tpu_torch.parallel.memplan import (config_only,
                                                       dry_run_serve)
        _report(dry_run_serve(config_only(args.model, args.ckpt),
                              max(args.tp, 1), max_batch=args.max_batch,
                              max_len=args.max_len, paged=args.paged,
                              page_size=args.page_size), args.hbm_gb)
        return
    if not args.paged and args.prefix_cache:
        raise SystemExit("--prefix-cache requires --paged")
    if not args.paged and args.kv_quant == "fp8":
        raise SystemExit("--kv-quant fp8 requires --paged (dense "
                         "quantized serving uses the int8 transposed-K "
                         "fused kernel; fp8 pools are paged-only)")
    if args.paged and args.kv_quant == "int4":
        raise SystemExit("--kv-quant int4 is dense-engine only (no int4 "
                         "paged pools); drop --paged")
    if args.tp > 1 and args.fuse_decode:
        raise SystemExit("--tp uses per-projection TP kernels; "
                         "drop --fuse-decode")
    if not args.ckpt:
        raise SystemExit("serve needs --ckpt DIR")
    if _multi_host(args):
        from onebit_tpu_torch.engine.tp_serve import serve_rank
        serve_rank(args)
        return
    if args.tp > 1:
        from onebit_tpu_torch.engine.tp_serve import serve_tp
        serve_tp(args)
        return
    eng = serve_engine(args, args.device)
    tok = _load_tokenizer(args.tokenizer) if args.tokenizer else None
    if args.http is not None:
        import time

        from onebit_tpu_torch.engine.server import EngineServer
        server = EngineServer(eng, tokenizer=tok)
        port = server.start(host=args.host, port=args.http)
        print(serving_line(args.host, port), flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.stop()
        return
    prompts = read_prompts(sys.stdin, tok)
    uids = [eng.add_request(ids, max_new_tokens=args.max_new_tokens)
            for _, ids in prompts]
    out = eng.run()
    print_completions(prompts, [out[u] for u in uids], tok)


def serve_engine(args, device, tp_group=None):
    """The ``serve`` flags' engine on ``device``: the checkpoint, and the
    draft's, loaded there; with ``tp_group`` one rank's engine over its
    shards."""
    from onebit_tpu_torch.engine.batching import ContinuousBatchingEngine
    from onebit_tpu_torch.engine.sampler import SamplingConfig

    loaded = _load_any_ckpt(args.ckpt, device)
    config, params = loaded["config"], loaded["params"]
    if args.fuse_decode:
        from onebit_tpu_torch.model.bitllama import fuse_for_decode
        params = fuse_for_decode(params, config)
    sampling = SamplingConfig(greedy=args.greedy,
                              temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    draft = (_load_any_ckpt(args.draft, device) if args.draft
             else {"params": None, "config": None})
    return ContinuousBatchingEngine(
        params, config, max_batch=args.max_batch, max_len=args.max_len,
        sampling=sampling, block_steps=args.block_steps, paged=args.paged,
        quantized_kv=args.kv_quant or False, page_size=args.page_size,
        prefix_cache=args.prefix_cache,
        prefill_chunk_size=args.prefill_chunk,
        draft_params=draft["params"], draft_config=draft["config"],
        n_draft=args.n_draft, pipeline_blocks=args.pipeline_blocks,
        device=device, tp_group=tp_group)


def serving_line(host: str, port: int) -> str:
    return f"serving on http://{host}:{port} (POST /generate, GET /metrics)"


def read_prompts(lines, tok) -> list:
    """``(line, token ids)`` of every non-empty line, ids comma-separated
    or, with a tokenizer ``tok``, the line's text encoded."""
    prompts = []
    for line in lines:
        line = line.strip()
        if line:
            prompts.append((line, tok(line)["input_ids"] if tok
                            else [int(t) for t in line.split(",")]))
    return prompts


def print_completions(prompts, outputs, tok) -> None:
    """One JSON line a request, in the order of its line (its uid's,
    onebit_tpu/cli.py:506-518): ``outputs`` are the requests' tokens."""
    for (line, _), toks in zip(prompts, outputs):
        text = tok.decode(toks) if tok else ",".join(map(str, toks))
        print(json.dumps({"prompt": line, "completion": text}))


def _device_flag(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where to run: cuda (default) or cpu")


def _add_dist_args(sp) -> None:
    """The multi-host flags (onebit_tpu/cli.py:525-544): the same command
    in every process, each with its ``--process-id``."""
    sp.add_argument("--coordinator", help="HOST:PORT of rank 0's store "
                    "(a multi-host launch)")
    sp.add_argument("--num-processes", type=int,
                    help="the processes of the launch, one rank each")
    sp.add_argument("--process-id", type=int,
                    help="this process's rank (0-based)")
    sp.add_argument("--distributed", action="store_true",
                    help="join the group from torchrun's environment (RANK, "
                    "WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")


def _multi_host(args) -> bool:
    return bool(getattr(args, "distributed", False)
                or getattr(args, "coordinator", None) is not None)


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank_device(args) -> str:
    """This process's device: ``args.device``, or in a group
    ``cuda:{rank % device_count}`` (made current) or the CPU."""
    if _world() == 1:
        return args.device
    import torch
    import torch.distributed as dist

    from onebit_tpu_torch.parallel.mesh import rank_device
    dev = rank_device(dist.get_rank(), args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return str(dev)


def _maybe_init_distributed(args) -> None:
    """Join the default process group from the multi-host flags, before any
    computation (onebit_tpu/cli.py:547-562). ``serve`` joins in
    ``engine/tp_serve.py``, as one of its tensor-parallel ranks."""
    if not _multi_host(args):
        if args.num_processes is not None or args.process_id is not None:
            raise SystemExit("--num-processes and --process-id go with "
                             "--coordinator")
        return
    if args.coordinator is not None and (args.num_processes is None
                                         or args.process_id is None):
        raise SystemExit("--coordinator requires --num-processes and "
                         "--process-id")
    if args.fn is cmd_serve:
        return
    from onebit_tpu_torch.parallel.mesh import initialize_distributed
    backend = "nccl" if args.device == "cuda" else "gloo"
    try:
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, backend=backend)
    except ValueError as e:
        raise SystemExit(str(e))


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

    bd = sub.add_parser("build-draft", help="slice a shallow speculative-"
                        "decoding draft from a student checkpoint")
    bd.add_argument("student")
    bd.add_argument("out")
    bd.add_argument("--num-layers", type=int, default=2)
    bd.add_argument("--strategy", default="spread",
                    choices=["first", "spread"])
    bd.add_argument("--for-training", action="store_true",
                    help="latentize packed slices into a trainable start "
                    "point for `train --student OUT --teacher STUDENT`")
    _device_flag(bd)
    bd.set_defaults(fn=cmd_build_draft)

    t = sub.add_parser("train", help="KD training")
    t.add_argument("--student", help="native start checkpoint (latent)")
    t.add_argument("--teacher", help="native teacher checkpoint")
    t.add_argument("--tokens", help="pre-tokenized blocks .npy [N, S]")
    t.add_argument("--data", help="dataset directory (with "
                   "dataset_info.json) of --dataset")
    t.add_argument("--dataset", help="registered text dataset name, "
                   "tokenized into --cutoff-len blocks (without --tokens)")
    t.add_argument("--tokenizer", help="tokenizer directory for --data "
                   "(default: the teacher's)")
    t.add_argument("--cutoff-len", type=int, default=2048,
                   help="block length of --data datasets")
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
    t.add_argument("--config", help="yaml or json file of train flags "
                   "(its keys are the flags' names; its values override "
                   "the command line's)")
    t.add_argument("--sharded-ckpt", action="store_true",
                   help="train states as sharded checkpoints: each rank "
                   "writes its blocks (torch.distributed.checkpoint)")
    t.add_argument("--dry-compile", action="store_true",
                   help="print one rank's memory plan of the sharded KD "
                   "step at real geometry on fake tensors: no weights, no "
                   "card")
    t.add_argument("--model", help="named geometry for --dry-compile "
                   "(llama-7b/llama2-7b/llama-13b/llama2-13b)")
    t.add_argument("--mesh", default="4x2",
                   help="DATAxMODEL mesh for --dry-compile (default 4x2)")
    t.add_argument("--hbm-gb", type=float, default=None,
                   help="exit nonzero when --dry-compile's per-card peak "
                   "passes this budget (H100: 80)")
    _add_dist_args(t)
    t.set_defaults(fn=cmd_train)
    e = sub.add_parser("eval", help="perplexity and zero-shot eval")
    e.add_argument("--ckpt", required=True, help="native or reference "
                   "checkpoint dir")
    e.add_argument("--tokens", help="pre-tokenized stream .npy for ppl")
    e.add_argument("--wikitext", help="raw wikitext pages file (rolling "
                   "word/byte perplexity)")
    e.add_argument("--tasks", help="comma list of registry names and "
                   "fnmatch patterns (piqa,arc_*,...); hendrycksTest: every "
                   "MMLU subject")
    e.add_argument("--tokenizer", help="tokenizer directory for --corpus, "
                   "--wikitext and --tasks (default: --ckpt)")
    e.add_argument("--corpus", help="comma list of ppl corpora (wikitext2,"
                   "c4,c4_new,ptb,ptb_new) loaded by protocol")
    e.add_argument("--corpus-source", help="local corpus path (text/jsonl/"
                   "load_from_disk dir) for --corpus")
    e.add_argument("--num-fewshot", type=int, default=0)
    e.add_argument("--task-source", help="directory of local task data "
                   "(DIR/NAME/<split>.jsonl|.json|.csv|.parquet or an HF "
                   "save_to_disk dir): --tasks offline")
    e.add_argument("--decontaminate", help="training text file to 13-gram-"
                   "scan task docs against; adds <metric>_decontaminate "
                   "columns computed over clean docs only")
    e.add_argument("--seqlen", type=int, default=2048)
    e.add_argument("--batch-size", type=int, default=4)
    e.add_argument("--limit", type=int)
    e.add_argument("--vocab-chunk", type=int, default=None,
                   help="stream the ppl lm_head/CE in vocab chunks of this "
                   "size (online logsumexp)")
    e.add_argument("--expect", help="pinned expected-numbers JSON; exits "
                   "nonzero when any metric misses its tolerance")
    _device_flag(e)
    e.add_argument("--check-engines", nargs="?", const="all", default=None,
                   help="greedy cross-check of the serving engines against "
                   "generate: a comma list of dense, pipelined, kvq, int4, "
                   "paged (the bare flag: all); adds engine_check.* to the "
                   "results")
    _add_dist_args(e)
    e.set_defaults(fn=cmd_eval)

    g = sub.add_parser("generate", help="generation from token ids")
    g.add_argument("--ckpt", required=True, help="native or reference "
                   "checkpoint dir")
    g.add_argument("--prompt", required=True,
                   help="comma-separated token ids, or text with "
                   "--tokenizer")
    g.add_argument("--tokenizer", help="tokenizer directory: the prompt is "
                   "text, and the output is printed as text")
    g.add_argument("--max-new-tokens", type=int, default=64)
    g.add_argument("--greedy", action="store_true")
    g.add_argument("--num-beams", type=int, default=1,
                   help="beam search above 1 (prints the best beam)")
    g.add_argument("--length-penalty", type=float, default=1.0,
                   help="beam scores: sum logp / length ** this")
    g.add_argument("--temperature", type=float, default=0.95)
    g.add_argument("--top-k", type=int, default=50)
    g.add_argument("--top-p", type=float, default=0.7)
    _device_flag(g)
    g.set_defaults(fn=cmd_generate)

    sv = sub.add_parser("serve", help="continuous-batching serving loop "
                        "(prompts on stdin, or --http)")
    sv.add_argument("--ckpt", help="native or reference checkpoint dir")
    sv.add_argument("--tokenizer", help="tokenizer directory: stdin lines "
                    "are text, and HTTP bodies may send 'text'")
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
                    help="quantized KV cache: with --paged int8 or fp8 "
                    "pages; without, the int8 or int4 transposed-K pools "
                    "of the fused append+attend kernels")
    sv.add_argument("--page-size", type=int, default=16)
    sv.add_argument("--prefix-cache", action="store_true",
                    help="share full prompt pages between requests "
                    "(requires --paged)")
    sv.add_argument("--prefill-chunk", type=int, default=None,
                    help="fixed-size chunked prefill (dense, int8 or paged "
                    "cache)")
    sv.add_argument("--draft", help="draft-model checkpoint for speculative "
                    "decoding (see build-draft)")
    sv.add_argument("--n-draft", type=int, default=4,
                    help="proposals a speculative round")
    sv.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: one process each on this "
                    "host, rank 0 the front end (stdin or --http)")
    sv.add_argument("--tp-backend", choices=["nccl", "gloo"], default=None,
                    help="the ranks' collectives: nccl (the default under "
                    "--device cuda; a card a rank) or gloo (the default "
                    "under --device cpu; ranks may share a card)")
    sv.add_argument("--dry-compile", action="store_true",
                    help="print one tensor-parallel rank's memory plan of a "
                    "decode step at real geometry on fake tensors")
    sv.add_argument("--model", help="named geometry for --dry-compile")
    sv.add_argument("--hbm-gb", type=float, default=None,
                    help="exit nonzero when --dry-compile's per-card peak "
                    "passes this budget (H100: 80)")
    _device_flag(sv)
    _add_dist_args(sv)
    sv.set_defaults(fn=cmd_serve)
    return p


def _apply_config_file(args) -> None:
    """``--config FILE`` (yaml, else json): the file's values become
    argument values (onebit_tpu/cli.py:80-95, reference core.py:50-77); an
    unknown key raises ``ValueError``."""
    with open(args.config) as f:
        if args.config.endswith((".yaml", ".yml")):
            import yaml
            data = yaml.safe_load(f)
        else:
            data = json.load(f)
    for key, val in data.items():
        attr = key.replace("-", "_")
        if not hasattr(args, attr):
            raise ValueError(f"unknown config key {key!r}")
        setattr(args, attr, val)


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.fn is cmd_train:
        if args.config:
            _apply_config_file(args)
        if not args.dry_compile and not (args.student and args.teacher):
            parser.error("train requires --student and --teacher (via "
                         "flags or --config)")
    if args.fn in (cmd_train, cmd_eval, cmd_serve):
        _maybe_init_distributed(args)
    try:
        args.fn(args)
    finally:
        if args.fn in (cmd_train, cmd_eval) and _world() > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
