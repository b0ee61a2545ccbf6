"""The device trace's interval arithmetic: the union, the gaps, their
labels, kernel names."""

import pytest

from bench.devtrace import (busy_seconds, device_ops, gap_breakdown,
                            idle_gaps, kernel_name, merged, seconds_of)

EVENTS = [("void a<float>(int)", 1.0, 2.0), ("b(x)", 1.5, 2.5),
          ("a", 4.0, 5.0), ("c", 9.5, 11.0)]


def test_union_and_busy():
    assert merged(EVENTS) == [(1.0, 2.5), (4.0, 5.0), (9.5, 11.0)]
    assert busy_seconds(EVENTS, 0.0, 10.0) == pytest.approx(3.0)


def test_gaps_cover_the_rest_of_the_window():
    gaps = idle_gaps(EVENTS, 0.0, 10.0)
    assert gaps == [(0.0, 1.0), (2.5, 4.0), (5.0, 9.5)]
    assert sum(b - a for a, b in gaps) + busy_seconds(EVENTS, 0, 10) == 10


def test_gaps_labelled_by_the_host_span():
    spans = [{"name": "decode_tick", "start": 2.0, "end": 3.5},
             {"name": "prefill_chunk", "start": 5.0, "end": 9.0},
             {"name": "request", "start": 0.0, "end": 10.0}]
    out = gap_breakdown([(0.0, 1.0), (2.5, 4.0), (5.0, 9.5)], spans)
    assert out[0] == ["total:prefill_chunk", 4.5]
    assert ["total:decode_tick", 1.5] in out
    assert ["total:neither", 1.0] in out
    assert out[3] == ["gap:prefill_chunk", 4.5]
    assert len(out) == 6


def test_kernel_names_and_their_seconds():
    assert kernel_name("void paged_split_kernel<__nv_bfloat16, 128>"
                       "(CUtensorMap, int)") == "paged_split_kernel"
    assert kernel_name("paged_mla_kernel(CUtensorMap const)") == \
        "paged_mla_kernel"
    assert kernel_name(
        "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel"
        "_impl<at::native::copy_kernel_cuda(at::TensorIterator&)::{lambda()"
        "#1}>(at::TensorIteratorBase&)>(int, float)") == \
        "at::native::elementwise_kernel"
    assert kernel_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
        "FillFunctor<float>, std::array<char*, 1ul>)") == \
        "at::native::vectorized_elementwise_kernel"
    assert device_ops(EVENTS, 0.0, 10.0)[0] == ["a", 2.0]
    assert seconds_of(EVENTS, r"\ba\b", 0.0, 10.0) == 2.0
    assert seconds_of(EVENTS, r"\bc\b", 0.0, 10.0) == pytest.approx(0.5)
