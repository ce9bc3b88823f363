"""SqueezeNet 1.0/1.1 (port of ``mxnet_tpu/gluon/model_zoo/vision/
squeezenet.py``; Iandola et al. 2016).  Each version is a flat layer
plan: a "fire" entry is one Fire module (squeeze 1x1, then parallel 1x1
and 3x3 expands concatenated on channels).  ``ceil_mode=True`` pools by
the "full" convention.
"""

from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]

# fire s: squeeze width s, expands (4*s, 4*s) — the paper's e=4s ratio
_PLANS = {
    "1.0": [("conv", 96, 7), "pool",
            ("fire", 16), ("fire", 16), ("fire", 32), "pool",
            ("fire", 32), ("fire", 48), ("fire", 48), ("fire", 64),
            "pool", ("fire", 64)],
    "1.1": [("conv", 64, 3), "pool",
            ("fire", 16), ("fire", 16), "pool",
            ("fire", 32), ("fire", 32), "pool",
            ("fire", 48), ("fire", 48), ("fire", 64), ("fire", 64)],
}


class Fire(HybridBlock):
    """squeeze(1x1) -> [expand1x1 | expand3x3] -> concat."""

    def __init__(self, squeeze, **kwargs):
        super().__init__(**kwargs)
        expand = 4 * squeeze
        with self.name_scope():
            self.squeeze = nn.Conv2D(squeeze, kernel_size=1)
            self.left = nn.Conv2D(expand, kernel_size=1)
            self.right = nn.Conv2D(expand, kernel_size=3, padding=1)

    def hybrid_forward(self, F, x):
        s = F.relu(self.squeeze(x))
        return F.concat(F.relu(self.left(s)), F.relu(self.right(s)),
                        dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _PLANS:
            raise ValueError("version must be one of %s"
                             % sorted(_PLANS))
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            for step in _PLANS[version]:
                if step == "pool":
                    f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                elif step[0] == "conv":
                    f.add(nn.Conv2D(step[1], kernel_size=step[2],
                                    strides=2))
                    f.add(nn.Activation("relu"))
                else:
                    f.add(Fire(step[1]))
            f.add(nn.Dropout(0.5))
            self.features = f
            head = nn.HybridSequential(prefix="")
            head.add(nn.Conv2D(classes, kernel_size=1))
            head.add(nn.Activation("relu"))
            head.add(nn.GlobalAvgPool2D())
            head.add(nn.Flatten())
            self.output = head

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(**kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return SqueezeNet("1.1", **kwargs)
