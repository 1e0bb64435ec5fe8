"""``serve --tp 2 --tp-backend gloo --device cpu`` (``engine/tp_serve.py``)
against the single-device ``serve`` on the same checkpoint, at the tiny
config on the CPU.

Two launches in all, each starting two rank processes: stdin mode
in-process (``cli.main``, with ``--draft``: every rank runs the
speculative round under TP), and ``--http 0`` in a process of its own
(``--paged --kv-quant fp8``: fp8 pages under TP), which answers one sync
and one ndjson request and then stops on SIGINT. The reference is the
single-device engine with the same flags: ``serve`` on stdin, and for each
HTTP request an engine serving it alone. Tolerance: none; both sides run
the same bf16 programs, the TP ones over each rank's half of the heads and
the vocabulary, and the tiny model's greedy tokens agree exactly. Every
process runs one torch thread (``OMP_NUM_THREADS=1``).
"""

import io
import json
import os
import select
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                              SamplingConfig, host_random_packed_params,
                              load_native)
from onebit_tpu_torch.ckpt.native import save_native
from onebit_tpu_torch.engine.tp_serve import FrontEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10]]
NEW = 6
FLAGS = ["--max-batch", "2", "--max-len", "64", "--max-new-tokens", str(NEW),
         "--greedy", "--device", "cpu"]
HTTP_FLAGS = ["--paged", "--kv-quant", "fp8", "--page-size", "4"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A tiny native checkpoint and its one-layer draft (``build-draft``)."""
    from onebit_tpu_torch import cli
    root = tmp_path_factory.mktemp("tp_serve")
    c = BitLlamaConfig.named("tiny")
    save_native(str(root / "ckpt"), c, host_random_packed_params(
        c, seed=0, dtype=torch.float32, device="cpu"))
    cli.main(["build-draft", str(root / "ckpt"), str(root / "draft"),
              "--num-layers", "1", "--device", "cpu"])
    return str(root / "ckpt"), str(root / "draft")


def _stdin_serve(argv, monkeypatch, capsys):
    from onebit_tpu_torch import cli
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "\n".join(",".join(map(str, p)) for p in PROMPTS) + "\n\n"))
    cli.main(["serve", *argv])
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_serve_tp_stdin_equals_single_device(ckpts, monkeypatch, capsys):
    """stdin mode with a draft: the launcher reads every line, both ranks
    serve them, rank 0's completions come out in JAX's JSON lines, equal
    to the single-device ``serve``'s."""
    ckpt, draft = ckpts
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--ckpt", ckpt, "--draft", draft, "--n-draft", "3", *FLAGS]
    want = _stdin_serve(argv, monkeypatch, capsys)
    got = _stdin_serve([*argv, "--tp", "2", "--tp-backend", "gloo"],
                       monkeypatch, capsys)
    assert [o["prompt"] for o in got] == [",".join(map(str, p))
                                          for p in PROMPTS]
    assert got == want
    assert all(len(o["completion"].split(",")) == NEW for o in got)


def _alone(ckpt, prompt):
    """The single-device engine of ``HTTP_FLAGS`` serving ``prompt``
    alone, as the server serves one request at a time."""
    loaded = load_native(ckpt, device="cpu")
    eng = ContinuousBatchingEngine(
        loaded["params"], loaded["config"], max_batch=2, max_len=64,
        sampling=SamplingConfig(greedy=True), paged=True, page_size=4,
        quantized_kv="fp8", device="cpu")
    uid = eng.add_request(prompt, max_new_tokens=NEW)
    return eng.run()[uid]


@pytest.fixture(scope="module")
def http_exchange(ckpts):
    """``serve --tp 2 --http 0`` in a process of its own: its first line,
    one sync and one ndjson POST /generate, GET /metrics, then SIGINT; the
    launcher's exit code and its stderr."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "onebit_tpu_torch", "serve", "--ckpt",
         ckpts[0], *FLAGS, *HTTP_FLAGS, "--tp", "2", "--tp-backend", "gloo",
         "--http", "0"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        ready = select.select([proc.stdout], [], [], 240)[0]
        line = proc.stdout.readline() if ready else ""
        assert line.startswith("serving on http://"), (
            line, proc.poll() is not None and proc.stderr.read()[-3000:])
        url = line.split()[2]

        def post(body):
            req = urllib.request.Request(
                url + "/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.headers["Content-Type"], r.read().decode()

        out = {"sync": post({"prompt": PROMPTS[1], "max_new_tokens": NEW}),
               "stream": post({"prompt": PROMPTS[0], "max_new_tokens": NEW,
                               "stream": True})}
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            out["metrics"] = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            out_rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            out_rc = None
    out["rc"], out["stderr"] = out_rc, proc.stderr.read()
    return out


def test_serve_tp_http_sync_equals_single_device(ckpts, http_exchange):
    """A sync POST /generate to rank 0's server over fp8 pages: the
    single-device engine's tokens; the metrics count the requests."""
    kind, body = http_exchange["sync"]
    assert kind == "application/json"
    assert json.loads(body) == {"tokens": _alone(ckpts[0], PROMPTS[1])}
    m = http_exchange["metrics"]
    assert m["completed_requests"] == 2 and m["total_tokens"] == 2 * NEW
    assert m["free_pages"] == m["total_pages"]


def test_serve_tp_http_stream_equals_single_device(ckpts, http_exchange):
    """An ndjson POST /generate: a chunk a token, then the done line, the
    single-device engine's tokens; SIGINT then stops the launcher, which
    stops every rank and exits 0."""
    kind, body = http_exchange["stream"]
    assert kind == "application/x-ndjson"
    chunks = [json.loads(x) for x in body.splitlines() if x]
    want = _alone(ckpts[0], PROMPTS[0])
    assert [c["token"] for c in chunks[:-1]] == want
    assert chunks[-1] == {"done": True, "tokens": want}
    assert http_exchange["rc"] == 0, http_exchange["stderr"][-3000:]


def test_front_engine_sends_each_steps_requests_first():
    """Before each step the front end passes on the requests added since
    the last one, in order and with their budgets, then steps: on the
    store while the other ranks have no work; while they have work, as the
    step's code (0 none, 1 read the store first), with a store message
    only where there are new requests. The stop goes the same way, and no
    step runs after it."""
    log = []
    work = iter([True, True, False, True])

    class Engine:
        uids = iter(range(10))

        def add_request(self, prompt, max_new_tokens=64, on_token=None,
                        on_done=None):
            return next(self.uids)

        def step(self):
            log.append("step")

        def has_work(self):
            return next(work)

        def metrics(self):
            return {}

    front = FrontEngine(Engine(), log.append, lambda c: log.append(c))
    assert [front.add_request([1, 2], 3), front.add_request([4], 5)] == [0, 1]
    front.step()                    # idle ranks: the store
    front.step()                    # busy: code 0, no message
    front.add_request([6], 7)
    front.step()                    # busy: a message, code 1; then idle
    front.add_request([8], 9)
    front.step()                    # idle: the store; then busy
    front.stop()                    # busy: code -1
    front.stop()
    front.step()
    assert log == [("step", [([1, 2], 3), ([4], 5)]), "step", 0, "step",
                   ("step", [([6], 7)]), 1, "step", ("step", [([8], 9)]),
                   "step", -1]


def test_store_channel_deletes_what_each_rank_read():
    """Rank 0's messages reach every other rank in order, each rank's copy
    under a key of its own that the rank deletes once read, so a long run
    leaves nothing behind in the store; an idle front end adds nothing."""
    import datetime

    import torch.distributed as dist

    from onebit_tpu_torch.engine.tp_serve import StoreChannel
    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=5))
    front, others = StoreChannel(store, 0, 3), [StoreChannel(store, r, 3)
                                                for r in (1, 2)]
    msgs = [("step", [([1, 2], 3)]), ("step", []), ("stop",)]
    for m in msgs:
        front.put(m)
    assert store.num_keys() == 2 * len(msgs)
    for ch in others:
        assert [ch.get() for _ in msgs] == msgs
    assert store.num_keys() == 0


def test_launch_stops_on_a_failed_rank(ckpts, monkeypatch, capsys):
    """A rank that fails (here every rank: the draft's directory holds no
    checkpoint) fails the launch nonzero with the rank's traceback, and no
    rank is left running."""
    from onebit_tpu_torch import cli
    bad = os.path.join(os.path.dirname(ckpts[0]), "empty")
    os.makedirs(bad, exist_ok=True)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr("sys.stdin", io.StringIO("1,2,3\n"))
    t = time.monotonic()
    with pytest.raises(SystemExit, match="serve --tp: rank .* failed") as e:
        cli.main(["serve", "--ckpt", ckpts[0], "--draft", bad, *FLAGS,
                  "--tp", "2", "--tp-backend", "gloo"])
    assert "Traceback" in str(e.value)
    assert time.monotonic() - t < 120
    import multiprocessing
    assert not multiprocessing.active_children()
