"""The port's profiling harness (``utils/profiling``): ``Timer``,
``annotate`` as a ``torch.profiler`` span, ``trace`` and the attention FLOP
estimate, the last against the JAX package's."""
import os

import pytest
import torch

from lipreading_video_generation_tpu.utils import profiling as jprof
from lipreading_video_generation_tpu_torch.utils import profiling as tprof


def test_timer_measures_a_function():
    t = tprof.Timer()
    stats = t.measure(lambda x: x * 2.0, torch.ones(64, 64), warmup=1, iters=3)
    assert sorted(stats) == ["mean_s", "median_s", "min_s", "std_s"]
    assert stats["mean_s"] > 0 and stats["min_s"] <= stats["median_s"]
    assert len(t.samples) == 3
    t.measure(lambda: {"a": [torch.ones(2)]}, warmup=0, iters=2)   # nested results, no warm-up
    assert len(t.samples) == 5


def test_annotate_is_a_span_of_the_profiler_and_trace_writes_it(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as prof:
        with tprof.annotate("test-span"):
            out = torch.ones(4).sum()
    assert float(out) == 4.0
    assert "test-span" in {e.key for e in prof.key_averages()}
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "test-span" in (tmp_path / "trace" / files[0]).read_text()


@pytest.mark.parametrize("b,h,s,d", [(1, 1, 128, 64), (4, 8, 80, 32), (2, 1, 16384, 64)])
def test_flops_estimate_equals_jax(b, h, s, d):
    assert tprof.flops_estimate_attention(b, h, s, d) == jprof.flops_estimate_attention(b, h, s, d)
    assert tprof.flops_estimate_attention(b, h, s, d) == 4 * b * h * s * s * d
