"""The int8 convolution's routes and the wgmma route's tiles
(`zebrapose_tpu_torch/ops/int8_conv.py`), on the CPU.

The wgmma kernel (`csrc/int8_conv.cu`) runs only on the card, where
chip_smoke.py's phase 14 holds it to the plain version bit for bit on
every quantized conv of the v2 forward and on edge sets for the shapes
the forward lacks. The shape arithmetic the wrapper does in Python is
held here:
  * `conv_route` sends every quantized conv of the model families (v2,
    v3, ResNet50) and of the card's edge sets where a TMA tensor map
    can describe it;
  * `tile_geometry` cuts 128 output pixels into a box TMA accepts.
"""

import pytest

import chip_smoke
import torch_threads  # noqa: F401  (torch threads a worker)
from zebrapose_tpu_torch.models.layers import quantized_convs
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.ops import int8_conv as k


@pytest.mark.parametrize("family, n_convs, gather", [
    (dict(variant="v2"), 37, set()),
    (dict(variant="v3"), 46, {"net.aspp_v3.conv_1x1_3"}),
    (dict(variant="v2", resnet_layers=50), 49, set()),
])
def test_conv_route_every_quantized_conv(family, n_convs, gather):
    """Every quantized conv takes the wgmma route but v3's 1025-channel
    fuse; ResNet50's stride-2 convs are among the wgmma ones."""
    model = ZebraPoseNet(binary_code_length=16, quant=True, **family)
    convs = quantized_convs(model)
    assert len(convs) == n_convs
    routes = {n: k.conv_route(c.weight.shape[1], c.stride[0])
              for n, c in convs.items()}
    assert {n for n, r in routes.items() if r == "gather"} == gather
    strided = [n for n, c in convs.items() if c.stride[0] == 2]
    assert len(strided) == (2 if family.get("resnet_layers") == 50 else 0)
    assert all(routes[n] == "wgmma" for n in strided)


def test_conv_route_edge_sets():
    """The card's edge sets take the route their names say."""
    routes = {e[0]: k.conv_route(e[4], e[7]) for e in chip_smoke.INT8_EDGES}
    assert {n for n, r in routes.items() if r == "gather"} == {
        "cin40", "Cin 1025 (v3's fuse) on the gather route"}
    assert k.conv_route(272, 1) == "wgmma"
    assert k.conv_route(256, 3) == "gather"


@pytest.mark.parametrize("wo, ho", [(128, 128), (64, 64), (32, 32), (1, 1),
                                    (17, 13), (200, 3), (5, 300)])
def test_tile_geometry(wo, ho):
    """TW x TH x TN = 128 pixels, powers of two, no wider than the map
    needs, and a box TMA takes (each extent <= 256 at stride 2)."""
    tw, th, tn = k.tile_geometry(wo, ho)
    assert tw * th * tn == k.TILE_PIXELS
    for v in (tw, th, tn):
        assert v & (v - 1) == 0
    assert tw == min(128, 1 << (wo - 1).bit_length())
    assert th <= max(1, 1 << (ho - 1).bit_length())
    assert max(2 * tw, 2 * th, tn) <= 256


GATHER_EDGES = {"cin40", "Cin 1025 (v3's fuse) on the gather route"}


@pytest.mark.parametrize("edge", chip_smoke.INT8_EDGES,
                         ids=[e[0] for e in chip_smoke.INT8_EDGES])
def test_edge_set_route_and_tile(edge):
    """Each card edge set takes its route; a wgmma one's output map gets
    a tile of 128 pixels whose box TMA accepts at its stride."""
    what, n, h, w, cin, cout, ks, s, p, d = edge[:10]
    route = k.conv_route(cin, s)
    assert route == ("gather" if what in GATHER_EDGES else "wgmma")
    ho, wo = k.out_size(h, ks, s, p, d), k.out_size(w, ks, s, p, d)
    assert ho >= 1 and wo >= 1
    if route == "wgmma":
        tw, th, tn = k.tile_geometry(wo, ho)
        assert tw * th * tn == k.TILE_PIXELS
        assert max(s * tw, s * th, tn) <= 256


def test_zero_counts():
    k.quantize_act.launches = 3
    k.int8_conv2d.launches = 2
    k.int8_conv2d.route_launches["gather"] = 2
    k.zero_counts()
    assert k.quantize_act.launches == k.int8_conv2d.launches == 0
    assert k.int8_conv2d.route_launches == {"wgmma": 0, "gather": 0}
