"""The traffic generator repeats exactly for a seed, and every seed gets
the same set of sizes in another order."""

import json

from portbench.harness import Bench
from portbench.traffic import Traffic

BENCH = Bench()


def _mix(name):
    return BENCH.mix(name)


def test_a_seed_repeats_exactly():
    for name in ("agent_chat", "doc_qa"):
        a = Traffic(_mix(name), 3_000_000_123, 32768)
        b = Traffic(_mix(name), 3_000_000_123, 32768)
        for i in (0, 1, 77, 5000):
            assert a.request(i) == b.request(i)
        if a.open:
            assert [a.arrival(i) for i in range(50)] == \
                [b.arrival(i) for i in range(50)]


def test_seeds_share_sizes_in_another_order():
    mix = _mix("agent_chat")
    a, b = Traffic(mix, 1, 32768), Traffic(mix, 2, 32768)
    n = mix["pool"]
    sa = sorted(a.sizes(i) for i in range(n))
    sb = sorted(b.sizes(i) for i in range(n))
    assert sa == sb
    assert [a.sizes(i) for i in range(n)] != [b.sizes(i) for i in range(n)]
    assert a.request(0)[0] != b.request(0)[0]


def test_sizes_and_ids_stay_in_range():
    mix = _mix("doc_qa")
    t = Traffic(mix, 2 ** 31 + 5, 102400)
    for i in range(40):
        ids, out = t.request(i)
        lo, hi = mix["prompt_tokens"]["min"], mix["prompt_tokens"]["max"]
        assert lo <= len(ids) <= hi
        assert mix["output_tokens"]["min"] <= out <= mix["output_tokens"]["max"]
        assert min(ids) >= 3 and max(ids) < 102400
    times = [t.arrival(i) for i in range(2 * mix["pool"])]
    assert all(b > a for a, b in zip(times, times[1:]))
    # the pool's gaps average to the rate
    assert abs(mix["pool"] / t.arrival(mix["pool"] - 1)
               - mix["rate_per_s"]) < 0.25 * mix["rate_per_s"]


def test_bucket_prompts_cover_the_pool():
    t = Traffic(_mix("agent_chat"), 7, 32768)
    buckets = t.bucket_prompts(32, 2048)
    assert set(buckets) <= {32, 64, 128, 256, 512, 1024}
    for n in t.prompt_lens.tolist():
        b = min(x for x in buckets if x >= n)
        assert buckets[b] >= n
    assert json.dumps(buckets)
