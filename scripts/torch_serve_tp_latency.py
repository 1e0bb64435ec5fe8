"""Per-token latency of ``serve --http`` on one card: one process, ``--tp 2``
from one launcher (the ranks on this host) and ``--tp 2`` as the two
processes of a multi-host launch (``--coordinator``), all on the same
2-layer checkpoint of llama2-7b width (random packed weights of seed 1).

Each launch answers one round of ``--concurrent`` requests sent together
(``--new`` tokens each, greedy), then one request alone, and reports the
engine's ``tpot_p50_s``/``tpot_p99_s`` from GET /metrics (rank 0's engine:
the time between a request's tokens, the front end's messages to the other
ranks included), each request's wall seconds a token as the client saw it,
and whether the tokens equal the one-process server's. The two ranks of
``--tp 2`` share the card over gloo (``--tp-backend gloo``).

``--root DIR`` runs the command line of another checkout (for example a
parent commit unpacked under ``build/``) on the same checkpoint; a checkout
without the multi-host flags runs ``--modes one,tp`` only.

    python scripts/torch_serve_tp_latency.py [--modes one,tp,multi_host]
        [--root DIR] [--concurrent 4] [--new 64]

Prints one JSON line a launch and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[1 + (7 * i + j) % 500 for j in range(16 + 24 * i)]
           for i in range(8)]


def _port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ckpt() -> str:
    sys.path.insert(0, HERE)
    import torch

    from onebit_tpu_torch import (BitLlamaConfig, host_random_packed_params,
                                  save_native)
    path = os.path.join(HERE, "build", "serve_latency_ckpt")
    if not os.path.exists(os.path.join(path, "params.npz")):
        config = BitLlamaConfig.named("llama2-7b", num_hidden_layers=2)
        save_native(path, config, host_random_packed_params(
            config, seed=1, device="cuda"))
        torch.cuda.empty_cache()
    return path


def _post(url, prompt, new, out, i):
    req = urllib.request.Request(
        url + "/generate", headers={"Content-Type": "application/json"},
        data=json.dumps({"prompt": prompt, "max_new_tokens": new}).encode())
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        tokens = json.loads(r.read())["tokens"]
    out[i] = (tokens, time.perf_counter() - t)


def launch(root, mode, ckpt, concurrent, new) -> dict:
    flags = ["--ckpt", ckpt, "--max-batch", str(concurrent), "--max-len",
             "512", "--max-new-tokens", str(new), "--greedy", "--http", "0"]
    tp = ["--tp", "2", "--tp-backend", "gloo"]
    cmd = [sys.executable, "-m", "onebit_tpu_torch", "serve", *flags]
    if mode == "one":
        cmds = [cmd]
    elif mode == "tp":
        cmds = [cmd + tp]
    else:
        coord = f"127.0.0.1:{_port()}"
        cmds = [cmd + tp + ["--coordinator", coord, "--num-processes", "2",
                            "--process-id", str(i)] for i in range(2)]
    procs = [subprocess.Popen(c, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    t0 = time.perf_counter()
    try:
        line = ""
        while "serving on" not in line:
            if procs[0].poll() is not None or not select.select(
                    [procs[0].stdout], [], [], 600)[0]:
                raise RuntimeError(f"{mode} did not start: "
                                   f"{procs[0].stderr.read()[-3000:]}")
            line = procs[0].stdout.readline()
        start_s = time.perf_counter() - t0
        url = line.split()[2]
        got = [None] * (concurrent + 1)
        threads = [threading.Thread(target=_post, args=(
            url, PROMPTS[i], new, got, i)) for i in range(concurrent)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        _post(url, PROMPTS[0], new, got, concurrent)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
    finally:
        procs[0].send_signal(signal.SIGINT)
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
    return {"mode": mode, "root": os.path.relpath(root, HERE),
            "start_s": start_s,
            "tpot_p50_s": metrics.get("tpot_p50_s"),
            "tpot_p99_s": metrics.get("tpot_p99_s"),
            "ttft_p50_s": metrics.get("ttft_p50_s"),
            "round_s_per_token": [s / len(t) for t, s in got[:concurrent]],
            "alone_s_per_token": got[concurrent][1] / len(got[concurrent][0]),
            "tokens": [t for t, _ in got], "exit_codes": rcs}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="one,tp,multi_host")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--concurrent", type=int, default=4)
    ap.add_argument("--new", type=int, default=64)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    ckpt = _ckpt()
    rows = [launch(os.path.abspath(args.root), m, ckpt, args.concurrent,
                   args.new) for m in args.modes.split(",")]
    for row in rows:
        row["same_tokens_as_first"] = row["tokens"] == rows[0]["tokens"]
        row["card"] = card
        print(json.dumps({k: v for k, v in row.items() if k != "tokens"}),
              flush=True)
    print(card)


if __name__ == "__main__":
    main()
