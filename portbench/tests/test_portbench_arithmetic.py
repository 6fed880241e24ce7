"""The FLOP, byte, roofline and idle arithmetic on hand-made inputs."""

import json

import pytest

from portbench.harness import roofline
from portbench.harness.spec import BENCH_DIR
from portbench.harness.trace import Trace, is_csrc, kernel_base, op_label


@pytest.fixture(scope="module")
def base_model():
    return json.loads((BENCH_DIR / "configs" / "ngp-base-oadd.json").read_text())["model"]


def test_heads_widths_and_flops(base_model):
    d = roofline.head_dims(base_model)
    assert d["density"] == [32, 64, 16] and d["rgb"] == [32, 64, 64, 3]
    # 32*64 + 64*16 + 32*64 + 64*64 + 64*3 multiply-adds a sample
    assert roofline.mlp_macs(base_model) == 9408
    assert roofline.mlp_flops(base_model, trained=False) == 18816
    assert roofline.mlp_flops(base_model, trained=True) == 56448


def test_heads_bytes(base_model):
    # forward: enc 32 + sh 16 in, rgb 3 + density 16 out; backward adds d_enc 32
    assert roofline.mlp_bytes(base_model, backward=False) == 4 * 67
    assert roofline.mlp_bytes(base_model, backward=True) == 4 * 99


def test_bound_takes_the_longer_side():
    b = roofline.bound(3.35e9, 1e9, 3.35e12, 989e12)
    assert b["bound_by"] == "bytes" and b["bound_s"] == pytest.approx(1e-3)
    b = roofline.bound(1.0, 989e9, 3.35e12, 989e12)
    assert b["bound_by"] == "operations" and b["bound_s"] == pytest.approx(1e-3)


def test_step_bound_at_2_18_samples(base_model):
    # both heads' passes are bound by bytes at these widths: (268 + 396) B a sample
    bw, flops = roofline.peaks("NVIDIA H100 80GB HBM3")
    n = 1 << 18
    assert roofline.mlp_step_bound_s(base_model, n, bw, flops) == pytest.approx(n * 664 / bw)


def test_peaks_by_card_name():
    assert roofline.peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 989e12)
    assert roofline.peaks("NVIDIA H100 PCIe") == (2.0e12, 756e12)
    with pytest.raises(KeyError):
        roofline.peaks("cpu")


@pytest.mark.parametrize(
    "intervals, union",
    [([], 0.0), ([(0, 1)], 1.0), ([(0, 1), (0.5, 2)], 2.0), ([(0, 1), (2, 3)], 2.0), ([(2, 3), (0, 4)], 4.0)],
)
def test_union_seconds(intervals, union):
    assert roofline.union_seconds(intervals) == pytest.approx(union)


def test_idle_share_and_gaps():
    ops = [("a", 1.0, 2.0), ("void b<2>(float*)", 1.5, 3.0), ("Memset (Device)", 6.0, 7.0)]
    tr = Trace(ops=ops, start=0.0, end=10.0, host=[("aten::sort", 3.0, 5.0), ("portbench_stretch", 0.0, 10.0)])
    assert tr.busy_s() == pytest.approx(3.0)
    assert 1.0 - tr.busy_s() / tr.window_s == pytest.approx(0.7)
    assert roofline.idle_gaps([(s, e) for _, s, e in ops], 0.0, 10.0) == [(0.0, 1.0), (3.0, 3.0), (7.0, 3.0)]
    gaps = tr.top_gaps(2)
    assert gaps[0] == ["aten::sort", 3.0] and gaps[1][1] == 3.0
    assert tr.top_ops(1) == [["b<2>", 1.5]]


def test_kernel_names():
    anon = "void (anonymous namespace)::hash_encode_fwd_kernel<2, 0>(float const*, float const*, float*, long long)"
    assert kernel_base(anon) == "hash_encode_fwd_kernel" and is_csrc(anon)
    assert kernel_base("(anonymous namespace)::adam_ema_kernel(float const*, float*, long long)") == "adam_ema_kernel"
    pool = "void at::native::(anonymous namespace)::max_pool3d_with_indices_single_out_frame<float>(float const*, int)"
    assert kernel_base(pool) == "max_pool3d_with_indices_single_out_frame" and not is_csrc(pool)
    assert op_label("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert kernel_base("void hash_encode_fwd_kernel<2, 0>(float const*, float const*, float*, long long)") == "hash_encode_fwd_kernel"
    assert kernel_base("fused_mlp_bwd_kernel") == "fused_mlp_bwd_kernel"
    assert is_csrc("void adam_ema_kernel(float const*, float*)")
    assert not is_csrc("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)")


def test_judge_fails_an_unnamed_number_and_reports_a_null_limit():
    from portbench.reference.compare import judge

    assert judge({"a": 1.0, "b": 5.0}, {"a": 2.0, "b": None}) == (True, {"a": {"value": 1.0, "limit": 2.0},
                                                                       "b": {"value": 5.0, "limit": None}})
    assert not judge({"a": 1.0, "c": 0.0}, {"a": 2.0})[0]
    assert not judge({"a": 3.0}, {"a": 2.0})[0]
    assert not judge({"a": float("nan")}, {"a": 2.0})[0]
