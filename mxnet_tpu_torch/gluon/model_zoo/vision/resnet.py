"""ResNet v1/v2, depths 18-152 (port of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``).

One ``ResidualUnit`` parameterized by (bottleneck, pre_act) stands for
the reference's four block classes: v1 is conv-BN-ReLU with the ReLU
after the addition, v2 the pre-activation variant.  Parameter names are
the JAX package's (``resnetv10_stage1_conv0_weight``), so weights and
checkpoints cross between the packages.
"""

from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "ResidualUnit", "BasicBlockV1",
           "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "SpaceToDepthStem", "resnet18_v1", "resnet34_v1", "resnet50_v1",
           "resnet101_v1", "resnet152_v1", "resnet18_v2", "resnet34_v2",
           "resnet50_v2", "resnet101_v2", "resnet152_v2", "get_resnet"]

# depth -> (bottleneck?, units per stage, stage output channels)
_SPECS = {
    18: (False, (2, 2, 2, 2), (64, 128, 256, 512)),
    34: (False, (3, 4, 6, 3), (64, 128, 256, 512)),
    50: (True, (3, 4, 6, 3), (256, 512, 1024, 2048)),
    101: (True, (3, 4, 23, 3), (256, 512, 1024, 2048)),
    152: (True, (3, 8, 36, 3), (256, 512, 1024, 2048)),
}
_STEM_CHANNELS = 64


def _conv(ch, k, s, p):
    return nn.Conv2D(ch, kernel_size=k, strides=s, padding=p,
                     use_bias=False)


class ResidualUnit(HybridBlock):
    """One residual unit.

    bottleneck: 1x1 -> 3x3 -> 1x1 (channels / 4 inner width), else two
    3x3.  pre_act (v2): BN-ReLU comes before the convs and the shortcut
    branches off the activated tensor; otherwise (v1) conv-BN-ReLU, with
    the ReLU after the addition.  A unit that changes the stride or the
    width projects its shortcut with a 1x1 conv (and, in v1, a BN).
    """

    def __init__(self, channels, stride, in_channels, bottleneck,
                 pre_act, **kwargs):
        super().__init__(**kwargs)
        self._pre_act = pre_act
        self._project = stride != 1 or in_channels != channels
        inner = channels // 4 if bottleneck else channels
        if bottleneck:
            # v1 strides the leading 1x1, v2 the 3x3 (the two papers)
            if pre_act:
                plan = [(inner, 1, 1, 0), (inner, 3, stride, 1),
                        (channels, 1, 1, 0)]
            else:
                plan = [(inner, 1, stride, 0), (inner, 3, 1, 1),
                        (channels, 1, 1, 0)]
        else:
            plan = [(channels, 3, stride, 1), (channels, 3, 1, 1)]
        with self.name_scope():
            self.convs = []
            self.bns = []
            for j, (ch, k, s, p) in enumerate(plan):
                conv = _conv(ch, k, s, p)
                bn = nn.BatchNorm()
                setattr(self, "conv%d" % j, conv)
                setattr(self, "bn%d" % j, bn)
                self.convs.append(conv)
                self.bns.append(bn)
            if self._project:
                self.proj = _conv(channels, 1, stride, 0)
                if not pre_act:
                    self.proj_bn = nn.BatchNorm()

    def hybrid_forward(self, F, x):
        if self._pre_act:
            y = F.Activation(self.bns[0](x), act_type="relu")
            shortcut = self.proj(y) if self._project else x
            h = self.convs[0](y)
            for conv, bn in zip(self.convs[1:], self.bns[1:]):
                h = conv(F.Activation(bn(h), act_type="relu"))
            return h + shortcut
        h = x
        last = len(self.convs) - 1
        for j, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            h = bn(conv(h))
            if j != last:
                h = F.Activation(h, act_type="relu")
        shortcut = self.proj_bn(self.proj(x)) if self._project else x
        return F.Activation(h + shortcut, act_type="relu")


class SpaceToDepthStem(HybridBlock):
    """The ImageNet stem as space-to-depth(2) of the input, then a
    4x4/stride-1 conv on 12 channels, in place of a 7x7/stride-2 conv on
    3: the same output grid, a receptive field that covers the 7x7's.
    Opt in with ``get_model(..., stem='s2d')``; its weight shape is not
    the conv7 stem's."""

    def __init__(self, channels, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.conv = _conv(channels, 4, 1, 2)

    def hybrid_forward(self, F, x):
        h = self.conv(F.space_to_depth(x, block_size=2))
        # k = 4, pad = 2 gives one more row and column than the 7x7/s2
        # grid; the aligned output is the leading slice
        return F.slice(h, begin=(0, 0, 0, 0), end=(None, None, -1, -1))


class _ResNet(HybridBlock):
    def __init__(self, depth, pre_act, classes=1000, thumbnail=False,
                 stem="conv7", **kwargs):
        super().__init__(**kwargs)
        bottleneck, units, widths = _SPECS[depth]
        with self.name_scope():
            body = nn.HybridSequential(prefix="")
            if pre_act:
                body.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:      # CIFAR-style 32x32 stem
                body.add(_conv(_STEM_CHANNELS, 3, 1, 1))
            else:              # ImageNet stem
                if stem == "s2d":
                    body.add(SpaceToDepthStem(_STEM_CHANNELS))
                elif stem == "conv7":
                    body.add(_conv(_STEM_CHANNELS, 7, 2, 3))
                else:
                    raise ValueError("stem must be 'conv7' or 's2d'")
                body.add(nn.BatchNorm())
                body.add(nn.Activation("relu"))
                body.add(nn.MaxPool2D(3, 2, 1))
            in_ch = _STEM_CHANNELS
            for s, (n_units, width) in enumerate(zip(units, widths)):
                stage = nn.HybridSequential(prefix="stage%d_" % (s + 1))
                with stage.name_scope():
                    for u in range(n_units):
                        stage.add(ResidualUnit(
                            width, 2 if (s > 0 and u == 0) else 1,
                            in_ch, bottleneck, pre_act, prefix=""))
                        in_ch = width
                body.add(stage)
            if pre_act:
                body.add(nn.BatchNorm())
                body.add(nn.Activation("relu"))
            body.add(nn.GlobalAvgPool2D())
            body.add(nn.Flatten())
            self.features = body
            self.output = nn.Dense(classes, in_units=in_ch)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    def __init__(self, depth=50, **kwargs):
        super().__init__(depth, pre_act=False, **kwargs)


class ResNetV2(_ResNet):
    def __init__(self, depth=50, **kwargs):
        super().__init__(depth, pre_act=True, **kwargs)


# the reference's block classes, as factories of ResidualUnit
def BasicBlockV1(channels, stride, downsample=False, in_channels=0,
                 **kwargs):
    return ResidualUnit(channels, stride, in_channels, False, False,
                        **kwargs)


def BasicBlockV2(channels, stride, downsample=False, in_channels=0,
                 **kwargs):
    return ResidualUnit(channels, stride, in_channels, False, True,
                        **kwargs)


def BottleneckV1(channels, stride, downsample=False, in_channels=0,
                 **kwargs):
    return ResidualUnit(channels, stride, in_channels, True, False,
                        **kwargs)


def BottleneckV2(channels, stride, downsample=False, in_channels=0,
                 **kwargs):
    return ResidualUnit(channels, stride, in_channels, True, True,
                        **kwargs)


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """ResNet-*num_layers* of *version* 1 or 2."""
    if num_layers not in _SPECS:
        raise ValueError("no resnet-%s; depths: %s"
                         % (num_layers, sorted(_SPECS)))
    if version not in (1, 2):
        raise ValueError("resnet version must be 1 or 2")
    if pretrained:
        raise ValueError("no pretrained weights are stored; load them with "
                         "gluon.load_jax_params")
    cls = ResNetV1 if version == 1 else ResNetV2
    return cls(num_layers, **kwargs)


def _factory(version, depth):
    def make(**kwargs):
        return get_resnet(version, depth, **kwargs)
    make.__name__ = "resnet%d_v%d" % (depth, version)
    make.__doc__ = "ResNet-%d v%d" % (depth, version)
    return make


resnet18_v1 = _factory(1, 18)
resnet34_v1 = _factory(1, 34)
resnet50_v1 = _factory(1, 50)
resnet101_v1 = _factory(1, 101)
resnet152_v1 = _factory(1, 152)
resnet18_v2 = _factory(2, 18)
resnet34_v2 = _factory(2, 34)
resnet50_v2 = _factory(2, 50)
resnet101_v2 = _factory(2, 101)
resnet152_v2 = _factory(2, 152)
