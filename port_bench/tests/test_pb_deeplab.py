"""The DeepLabV3+ configuration's harness pieces on the CPU: its reference's
parameter tree against the program's, its layer tables against counts by
hand, and its cell run once at a tiny size through ``run_cell``."""

import json
import shutil
import time
from pathlib import Path

import pytest

from port_bench import counts, spec
from port_bench.reference import deeplabv3plus
from port_bench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "dlv3p101.train.b96"


def config():
    return json.loads((ROOT / "port_bench" / "configs" /
                       "deeplabv3plus_resnet101.json").read_text())


def test_weight_tree_is_the_program_tree():
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_model

    cfg = config()
    model = create_model("DeepLabV3Plus", cfg["encoder_name"], classes=cfg["classes"],
                         layout="smp", device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        n: tuple(s) for n, s, _ in deeplabv3plus.weight_spec(cfg)}


def test_a_depthwise_conv_counts_its_own_taps():
    # aspp_r24_depthwise at 512 px: 2048 channels at /16 (32 x 32), one 3x3
    # filter a channel: 2 * 9 * 2048 * 32 * 32 operations, whatever the rate
    layers = {name: rest for name, *rest in deeplabv3plus.conv_layers(config(), 512)}
    cin, cout, k, stride, h, w = layers["aspp_r24_depthwise"]
    assert (cin, cout, k, stride, h, w) == (1, 2048, 3, 1, 32, 32)
    assert counts.forward_flops([("aspp_r24_depthwise", cin, cout, k, stride, h, w)]) \
        == 2 * 9 * 2048 * 32 * 32 == 37_748_736
    # the separable 3x3 of the decoder at /4: 304 channels at 128 x 128
    assert layers["fuse_depthwise"] == [1, 304, 3, 1, 128, 128]
    assert layers["fuse_pointwise"] == [304, 256, 1, 1, 128, 128]


def test_the_dilated_stage_and_the_whole_forward():
    cfg = config()
    layers = deeplabv3plus.conv_layers(cfg, 512)
    stage4 = [l for l in layers if l[0].startswith("encoder.stage4_")]
    # stage 4 at /16: no stride, every output 32 x 32
    assert {(s, h, w) for _n, _c, _o, _k, s, h, w in stage4} == {(1, 32, 32)}
    # block0: 1x1 1024->512, 3x3 512->512, 1x1 512->2048, downsample 1024->2048,
    # then two blocks of 1x1 2048->512, 3x3, 1x1 512->2048, all at 32^2
    px = 32 * 32
    block0 = 2 * px * (1024 * 512 + 9 * 512 * 512 + 512 * 2048 + 1024 * 2048)
    block = 2 * px * (2048 * 512 + 9 * 512 * 512 + 512 * 2048)
    assert counts.forward_flops(stage4) == block0 + 2 * block == 30_601_641_984
    assert counts.forward_flops(layers) == 112_095_920_128
    norms = deeplabv3plus.bn_inputs(cfg, 512)
    assert len(norms) == 113
    assert ("aspp_pool_norm", 256, 1, 1) in norms and ("fuse_norm", 256, 128, 128) in norms


def test_the_cell_runs_at_a_tiny_size(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_dir = tmp_path / "port_bench"
    (bench_dir / "traffic" / "tiny_b4.json").write_text(json.dumps(
        {"kind": "train_epoch", "batch": 4, "tile": 64, "ring_tiles": 16}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dlv3p101.tiny", "config": "deeplabv3plus_resnet101",
                               "traffic": "tiny_b4", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("dlv3p101.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.Cell(bench, "dlv3p101.tiny", bench_dir=bench_dir, root=tmp_path)
    assert {"bilinear_ms.train", "depthwise_ms.train", "mfu.train"} <= {
        m["name"] for m in cell.per_layer}
    (tmp_path / "run").mkdir()
    result = run_cell(cell, 2 ** 31 + 23, 1.0, False, "cpu", time.perf_counter(),
                      str(tmp_path / "run"))
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap", "stats_gap"}
    # the dropout draws the same masks on both sides: the losses agree
    assert result["checks"]["loss_gap"]["value"] < 0.05
    assert result["metrics"]["train_tiles_per_s"]["value"] > 0


def _trace(events, steps=2):
    from port_bench.trace import Trace

    return Trace([{"name": n, "cat": "kernel", "ts": float(i), "dur": dur, "bytes": None}
                  for i, (n, dur) in enumerate(events)], [], (0.0, 1e6), {"steps": steps})


DENSE = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_"
         "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn")


@pytest.mark.parametrize("name", ["bilinear_ms.train", "depthwise_ms.train"])
def test_a_reader_finds_nothing_in_a_trace_without_its_kernels(name):
    cell = spec.Cell(spec.load(), CELL)
    assert cell.reader(name)(_trace([(DENSE, 5.0)])) is None
    assert cell.reader(name)(_trace([(DENSE, 5.0)], steps=0)) is None


def test_the_readers_pick_their_kernels_by_name():
    cell = spec.Cell(spec.load(), CELL)
    t = _trace([
        ("void at::native::(anonymous namespace)::upsample_bilinear2d_backward_nhwc_out_frame"
         "<c10::BFloat16, float>(...)", 500.0),
        ("void at::native::(anonymous namespace)::upsample_bilinear2d_nhwc_out_frame"
         "<c10::BFloat16, float>(...)", 100.0),
        # the augmentation's float32 field resize is not the model's
        ("void at::native::upsample_bilinear2d_out_frame<float, float>(...)", 7.0),
        ("void cudnn::cnn::conv2d_grouped_direct_kernel<false, true, false, true, false, "
         "false, 0, 0, int, float, __nv_bfloat16>(...)", 300.0),
        ("void tensorTransformGeneric<__nv_bfloat16, __nv_bfloat16, float, true, false, "
         "false, (cudnnKernelDataType_t)0>(...)", 100.0),
        ("sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize"
         "64x64x64_stage4_warpsize1x1x4_g16_tensor16x8x16_execute_kernel__5x_cudnn", 80.0),
        ("sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize"
         "32x128x32_stage4_warpsize1x4x1_g1_tensor16x8x16_execute_kernel__5x_cudnn", 9.0),
        ("dgrad2d_c1_k1_nhwc", 10.0), ("dgrad2d_c1_k1_nhwc_specialized", 4.0),
        ("conv2d_c1_k1_nhwc_specialized", 3.0), ("wgrad2d_c1_k1_nhwc", 2.0),
        ("wgrad2d_c1_k1_nhwc_reduce", 1.0), (DENSE, 1000.0)])
    assert cell.reader("bilinear_ms.train")(t) == pytest.approx(0.3)
    assert cell.reader("depthwise_ms.train")(t) == pytest.approx(0.25)
