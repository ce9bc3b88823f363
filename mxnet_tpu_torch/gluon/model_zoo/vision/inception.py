"""Inception-v3 (port of ``mxnet_tpu/gluon/model_zoo/vision/
inception.py``; Szegedy et al. 2015, "Rethinking the Inception
Architecture"), input 3 x 299 x 299.  Each inception stage is a list of
branch specs, and one `_Branches` block runs them on the same input and
concatenates them on channels; hybridized, the network is one graph.
"""

from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _conv_bn(channels, kernel, stride=1, pad=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                      padding=pad, use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _chain(specs):
    """specs: list of (channels, kernel, stride, pad) conv specs, or the
    strings 'avgpool'/'maxpool' for the in-branch pooling steps."""
    seq = nn.HybridSequential(prefix="")
    for s in specs:
        if s == "avgpool":
            seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
        elif s == "maxpool":
            seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        else:
            seq.add(_conv_bn(*s))
    return seq


class _Branches(HybridBlock):
    """Run each branch on the same input and concat on channels."""

    def __init__(self, branch_specs, **kwargs):
        super().__init__(**kwargs)
        self.branches = []
        for i, specs in enumerate(branch_specs):
            b = _chain(specs)
            self.register_child(b)
            setattr(self, "branch%d" % i, b)
            self.branches.append(b)

    def hybrid_forward(self, F, x):
        return F.concat(*[b(x) for b in self.branches], dim=1)


# (channels, kernel, stride, pad); kernels may be rectangular tuples.
def _stage_a(pool_ch):
    return [[(64, 1, 1, 0)],
            [(48, 1, 1, 0), (64, 5, 1, 2)],
            [(64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 1, 1)],
            ["avgpool", (pool_ch, 1, 1, 0)]]


def _stage_b():
    return [[(384, 3, 2, 0)],
            [(64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 2, 0)],
            ["maxpool"]]


def _stage_c(ch7):
    return [[(192, 1, 1, 0)],
            [(ch7, 1, 1, 0), (ch7, (1, 7), 1, (0, 3)),
             (192, (7, 1), 1, (3, 0))],
            [(ch7, 1, 1, 0), (ch7, (7, 1), 1, (3, 0)),
             (ch7, (1, 7), 1, (0, 3)), (ch7, (7, 1), 1, (3, 0)),
             (192, (1, 7), 1, (0, 3))],
            ["avgpool", (192, 1, 1, 0)]]


def _stage_d():
    return [[(192, 1, 1, 0), (320, 3, 2, 0)],
            [(192, 1, 1, 0), (192, (1, 7), 1, (0, 3)),
             (192, (7, 1), 1, (3, 0)), (192, 3, 2, 0)],
            ["maxpool"]]


class _StageE(HybridBlock):
    """The expanded 8x8 stage: two of its branches themselves fork."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.b0 = _chain([(320, 1, 1, 0)])
        self.b1_stem = _chain([(384, 1, 1, 0)])
        self.b1a = _chain([(384, (1, 3), 1, (0, 1))])
        self.b1b = _chain([(384, (3, 1), 1, (1, 0))])
        self.b2_stem = _chain([(448, 1, 1, 0), (384, 3, 1, 1)])
        self.b2a = _chain([(384, (1, 3), 1, (0, 1))])
        self.b2b = _chain([(384, (3, 1), 1, (1, 0))])
        self.b3 = _chain(["avgpool", (192, 1, 1, 0)])
        for blk in (self.b0, self.b1_stem, self.b1a, self.b1b,
                    self.b2_stem, self.b2a, self.b2b, self.b3):
            self.register_child(blk)

    def hybrid_forward(self, F, x):
        y1 = self.b1_stem(x)
        y2 = self.b2_stem(x)
        return F.concat(self.b0(x), self.b1a(y1), self.b1b(y1),
                        self.b2a(y2), self.b2b(y2), self.b3(x), dim=1)


class Inception3(HybridBlock):
    """Inception v3; input 3x299x299."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            f.add(_conv_bn(32, 3, 2, 0))
            f.add(_conv_bn(32, 3, 1, 0))
            f.add(_conv_bn(64, 3, 1, 1))
            f.add(nn.MaxPool2D(pool_size=3, strides=2))
            f.add(_conv_bn(80, 1, 1, 0))
            f.add(_conv_bn(192, 3, 1, 0))
            f.add(nn.MaxPool2D(pool_size=3, strides=2))
            for pool_ch in (32, 64, 64):
                f.add(_Branches(_stage_a(pool_ch)))
            f.add(_Branches(_stage_b()))
            for ch7 in (128, 160, 160, 192):
                f.add(_Branches(_stage_c(ch7)))
            f.add(_Branches(_stage_d()))
            f.add(_StageE())
            f.add(_StageE())
            f.add(nn.GlobalAvgPool2D())
            f.add(nn.Dropout(0.5))
            self.features = f
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, classes=1000, **kwargs):
    if pretrained:
        raise ValueError("no hosted pretrained weights in this build; "
                         "use load_parameters() with a local file")
    return Inception3(classes=classes, **kwargs)
