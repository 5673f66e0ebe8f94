"""``counts.py`` over the reference U-Net's layer tables, against counts
worked by hand."""

import json
from pathlib import Path

import pytest

from port_bench import counts
from port_bench.reference import unet

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_a_3x3_conv():
    # decoder.block4.conv2 of a 512 px tile: 16 -> 16 channels, 3x3, 512 x 512
    # outputs, 2 operations a multiply-add: 2 * 16 * 9 * 16 * 512 * 512
    layers = {name: rest for name, *rest in unet.conv_layers(config("unet_resnet34"), 512)}
    cin, cout, k, stride, h, w = layers["decoder.block4.conv2"]
    assert (cin, cout, k, stride, h, w) == (16, 16, 3, 1, 512, 512)
    assert 2 * cin * k * k * cout * h * w == 1_207_959_552


def test_a_bottleneck_block():
    # resnet50's stage2_block0 at 512 px: input 256 ch at 128 x 128, stride 2.
    # conv1 1x1 256->128 at 128^2: 2*256*128*128^2      = 1,073,741,824
    # conv2 3x3 128->128 s2 at 64^2: 2*128*9*128*64^2   = 1,207,959,552
    # conv3 1x1 128->512 at 64^2:   2*128*512*64^2      =   536,870,912
    # downsample 1x1 256->512 s2 at 64^2: 2*256*512*64^2 = 1,073,741,824
    layers = unet.conv_layers(config("unet_resnet50"), 512)
    block = [(n, c, o, k, s, h, w) for n, c, o, k, s, h, w in layers
             if n.startswith("encoder.stage2_block0.")]
    assert [(c, o, k, s, h) for _n, c, o, k, s, h, _w in block] == [
        (256, 128, 1, 1, 128), (128, 128, 3, 2, 64), (128, 512, 1, 1, 64),
        (256, 512, 1, 2, 64)]
    flops = sum(2 * c * k * k * o * h * w for _n, c, o, k, _s, h, w in block)
    assert flops == 1_073_741_824 + 1_207_959_552 + 536_870_912 + 1_073_741_824


def test_one_batchnorm_input_bytes():
    # the stem's BatchNorm input at B=2, 512 px: 64 ch at 256 x 256 in bf16;
    # forward reads it once (8,388,608 elements * 2 bytes), the dual sums read
    # it and its gradient once (2 * 16,777,216), each pass writes 2 * 64 floats
    cfg = config("unet_resnet34")
    name, c, h, w = unet.bn_inputs(cfg, 512)[0]
    assert (name, c, h, w) == ("encoder.stem_norm", 64, 256, 256)
    one = dict(cfg, stage_sizes=[], decoder_channels=[])
    n = 2 * 64 * 256 * 256
    assert counts.bn_sums_bytes(unet.bn_inputs(one, 512), 2) == n * 2 + 2 * n * 2 + 2 * (2 * 64 * 4)


@pytest.mark.parametrize("name, gflop, norms", [("unet_resnet34", 64.1728512, 46),
                                                ("unet_resnet50", 86.721429504, 63)])
def test_whole_models(name, gflop, norms):
    # the forward a 512 px tile and the BatchNorm count (one channel_sums
    # launch each in the program's train step)
    cfg = config(name)
    layers = unet.conv_layers(cfg, 512)
    assert counts.forward_flops(layers) == pytest.approx(gflop * 1e9, rel=1e-12)
    assert len(unet.bn_inputs(cfg, 512)) == norms
    assert counts.train_step_flops(layers, 4) == 3 * 4 * counts.forward_flops(layers)
    assert counts.serve_flops(layers, 4) == 4 * counts.forward_flops(layers)
