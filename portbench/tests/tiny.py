"""A copy of the benchmark's files in a temporary folder with a tiny
configuration and tiny cells beside the real ones, so that a whole run
goes through on the CPU in seconds."""

import json
import shutil
from pathlib import Path

from portbench.harness import BENCH_DIR, Bench

TINY = {
    "source": "https://huggingface.co/mistralai/Mistral-7B-v0.3/blob/main/config.json",
    "hidden_size": 512, "intermediate_size": 1024, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 512,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-05,
    "max_position_embeddings": 4096, "tie_word_embeddings": False,
    "initializer_range": 0.02, "bos_token_id": 1, "eos_token_id": 2,
    "reduced": ["num_hidden_layers"], "assumed": {}, "deployment": "tests",
}
SERVE_MIX = {
    "kind": "serve", "loop": "closed", "clients": 4,
    "prompt_tokens": {"dist": "lognormal", "median": 40, "sigma": 0.5,
                      "min": 8, "max": 100},
    "output_tokens": {"dist": "uniform", "min": 8, "max": 24},
    "pool": 64, "pool_seed": 5, "ramp_s": 0.3, "greedy": True, "why": "t",
}
OPEN_MIX = dict(SERVE_MIX, loop="open", arrivals="poisson", rate_per_s=20.0)
TRAIN_MIX = {"kind": "train", "batch": 2, "seq_len": 32, "checked_steps": 3,
             "why": "t"}
ENGINE = {"max_batch": 4, "max_len": 256, "paged": True, "page_size": 16,
          "block_steps": 4, "pipeline_blocks": True}
CELLS = {
    "tiny.chat": {"config": "tiny", "traffic": "tiny_chat", "chips": 1,
                  "end_to_end": ["output_tok_s", "ttft_p90_ms",
                                 "tpot_p90_ms", "setup_s"],
                  "engine": ENGINE,
                  "check": {"requests": 2, "limits": {"served_gap": 0.03}},
                  "why": "t"},
    "tiny.rag": {"config": "tiny", "traffic": "tiny_open", "chips": 1,
                 "end_to_end": ["ttft_p90_ms", "tpot_p90_ms", "setup_s"],
                 "engine": dict(ENGINE, prefill_chunk_size=32),
                 "check": {"requests": 2, "limits": {"served_gap": 0.03}},
                 "why": "t"},
    "tiny.kd": {"config": "tiny", "traffic": "tiny_kd", "chips": 1,
                "end_to_end": ["train_tok_s", "setup_s"],
                "kd": {"kd_alpha": 1.0, "kd_beta": 1.0, "kd_gamma": 0.0,
                       "kd_loss_scale": 0.01},
                "train": {"learning_rate": 0.0004, "adam_beta1": 0.9,
                          "adam_beta2": 0.98, "weight_decay": 0.01,
                          "warmup_steps": 1, "total_steps": 1000,
                          "max_grad_norm": 1.0, "lr_schedule": "cosine",
                          "remat": False},
                "check": {"limits": {"loss_gap": 6e-4, "grad_gap": 4e-3,
                                     "change_gap": 4e-3}},
                "why": "t"},
}


def write(root: Path, kind: str, name: str, obj) -> None:
    (root / kind / f"{name}.json").write_text(json.dumps(obj))


def tiny_bench(tmp: Path) -> Bench:
    root = tmp / "portbench"
    shutil.copytree(BENCH_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    write(root, "configs", "tiny", TINY)
    write(root, "traffic", "tiny_chat", SERVE_MIX)
    write(root, "traffic", "tiny_open", OPEN_MIX)
    write(root, "traffic", "tiny_kd", TRAIN_MIX)
    for name, cell in CELLS.items():
        write(root, "workloads", name, cell)
    return Bench(root)
