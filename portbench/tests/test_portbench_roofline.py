"""The yardstick's byte and operation counts against hand-worked small
shapes."""

import pytest

from portbench import roofline as rl

CFG = {"hidden_size": 256, "intermediate_size": 512, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2,
       "vocab_size": 1000}


def test_bitlinear_work_counts_each_byte_once():
    # m 2, k 64, n 32, one segment, bf16 in and out
    w = rl.bitlinear_work(2, 64, 32)
    words, x, g, h, out = 2 * 32 * 4, 2 * 64 * 2, 64 * 2, 32 * 4, 2 * 32 * 2
    assert w.bytes == words + x + g + h + out
    assert w.flops == 2 * 2 * 64 * 32
    # fused q/k/v: three segments of 32 padded to 128 columns each
    f = rl.bitlinear_work(4, 64, 32, ns=3, n_cat=384)
    assert f.bytes == 2 * 384 * 4 + 4 * 64 * 2 + 3 * 64 * 2 + 384 * 4 \
        + 3 * 4 * 32 * 2
    assert f.flops == 2 * 4 * 64 * 3 * 32
    assert rl.bitlinear_work(1, 64, 32, elem=4, fp32=True).flops == \
        3 * 2 * 64 * 32


def test_least_time_is_the_larger_bound():
    w = rl.Work(bytes=3.35e12, flops=989e12 / 2)
    assert w.least_s() == pytest.approx(1.0)
    w = rl.Work(bytes=3.35e12 / 4, flops=989e12)
    assert w.least_s() == pytest.approx(1.0)
    assert rl.total_least_s([w, w]) == pytest.approx(2.0)


def test_paged_work():
    # two rows of 16 and 20 positions, nkv 2, g 2, hd 8, pages of 16, bf16
    w = rl.paged_work([16, 20], 2, 2, 8, 16)
    q_out = 2 * 2 * 2 * 8 * (2 + 4) + 4 * 2
    kv = 2 * 2 * 16 * 8 * 2 + 2 * 2 * 20 * 8 * 2
    tables = 4 * 1 + 4 * 2
    assert w.bytes == q_out + kv + tables
    assert w.flops == 4 * 2 * 2 * 8 * (16 + 20)
    # int8 pages: one byte an element, a 4-byte scale a position and head
    q = rl.paged_work([16], 2, 2, 8, 16, quant=True)
    assert q.bytes == 1 * 2 * 2 * 8 * 6 + 4 + 2 * 2 * 16 * (8 + 4) + 4


def test_kv_work():
    w = rl.kv_work([4], 1, 2, 8, 16, int4=False, append=False)
    assert w.bytes == 2 * 1 * 1 * 2 * 8 * 2 + 1 * (2 * 8 * 4 + 8 * 4) + 4
    assert w.flops == 4 * 1 * 2 * 8 * 4
    a = rl.kv_work([4], 1, 2, 8, 16, int4=True, append=True)
    assert a.bytes == 2 * 2 * 8 * 2 + (2 * 8 * 4 + 8 * 4) + 8 + \
        2 * 1 * (16 + 8)


def test_flash_work():
    w = rl.flash_work(1, 4, 2, 1, 8)
    assert w.bytes == 2 * 4 * 8 * (4 + 2)
    assert w.flops == 4 * 2 * 8 * 10
    assert rl.flash_work(1, 4, 2, 1, 8, fp32=True).flops == 6 * w.flops
    dkv = rl.flash_bwd_work(1, 4, 2, 1, 8, "dkv")
    assert dkv.flops == 4 * 2 * 2 * 8 * 10
    assert dkv.bytes == 2 * 4 * 8 * 6 + 2 * 4 * 2 * 4 + 2 * 4 * 8 * 2
    dq = rl.flash_bwd_work(1, 4, 2, 1, 8, "dq")
    assert dq.flops == 3 * 2 * 2 * 8 * 10
    assert dq.bytes == 2 * 4 * 8 * 6 + 2 * 4 * 2 * 4 + 2 * 4 * 8 * 2


def test_model_work():
    per_layer = 256 * 256 * 2 + 2 * 128 * 256 + 3 * 512 * 256
    assert rl.layer_params(CFG) == per_layer
    assert rl.projections_work(CFG, 3).flops == 2 * 3 * per_layer * 2
    head = rl.lm_head_work(CFG, 3)
    assert head.bytes == 1000 * 256 * 2 + 3 * 256 * 2 + 3 * 1000 * 4
    assert rl.prompt_flops(CFG, 5) == 2 * 5 * per_layer * 2 + \
        4 * 4 * 64 * 15 * 2 + 2 * 256 * 1000
    tokens = 2 * 8
    gemm = 4 * 2 * tokens * per_layer * 2 + 3 * 2 * tokens * 256 * 1000
    assert rl.kd_gemm_flops(CFG, 2, 8) == gemm
    attn = 4 * 2 * 4 * 64 * 36 * 2
    assert rl.kd_step_flops(CFG, 2, 8) == gemm + 4.5 * attn


@pytest.mark.parametrize("name,ran,kernel", [
    ("bitlinear_large_roofline", 512, "project_large_m"),
    ("bitlinear_small_roofline", 64, "small_m_kernel")])
def test_prefill_rooflines_count_the_rows_prompts_need(name, ran, kernel):
    """A call that runs ``ran`` rows for 37 rows of prompt counts 37: a
    last chunk's or a bucket's padding is no work the traffic needs."""
    from portbench.harness import Bench, Context
    reader = Bench().metric(name)
    ctx = Context({}, CFG, {"max_batch": 4, "prof": {
        "token_steps": 0, "prefill_m": [(ran, 37)]}},
        {"kernels": {kernel: 1.0}})
    need = rl.projections_work(CFG, 37).least_s()
    assert reader.read(ctx) == pytest.approx(100.0 * need)
