"""Convolution and pooling Gluon layers (port of
``mxnet_tpu/gluon/nn/conv_layers.py``): Conv1D-3D, Conv1D-3DTranspose,
Max/Avg pooling and the global poolings."""

from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    """N-d convolution (*op_name* "Convolution"; weight (channels,
    in_channels / groups, *kernel_size)) or transposed convolution
    ("Deconvolution" with *adj*; weight (in_channels, channels / groups,
    *kernel_size)), the in_channels deferred when 0."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        with self.name_scope():
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups if in_channels
                          else 0) + tuple(kernel_size)
            else:
                wshape = (in_channels, channels // groups if channels
                          else 0) + tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, **self._kwargs)
        else:
            out = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return "{}({}, kernel_size={})".format(
            type(self).__name__, self._channels, self._kwargs["kernel"])


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1),
                         _tup(padding, 1), _tup(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3),
                         _tup(padding, 3), _tup(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    """N-d transposed convolution over ``Deconvolution``; an int argument
    is every axis, *output_padding* its ``adj``."""
    _n = 0
    _layout = ""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout=None,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        n = self._n
        super().__init__(channels, _tup(kernel_size, n), _tup(strides, n),
                         _tup(padding, n), _tup(dilation, n), groups,
                         layout or self._layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tup(output_padding, n), **kwargs)


class Conv1DTranspose(_ConvTranspose):
    _n, _layout = 1, "NCW"


class Conv2DTranspose(_ConvTranspose):
    _n, _layout = 2, "NCHW"


class Conv3DTranspose(_ConvTranspose):
    _n, _layout = 3, "NCDHW"


class _Pooling(HybridBlock):
    """Pooling over the spatial axes; ``ceil_mode`` is the "full"
    pooling convention."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "{}(size={}, stride={}, padding={})".format(
            type(self).__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"])


class _WindowPooling(_Pooling):
    """Max or avg pooling over windows of *pool_size* (an int is every
    axis), *strides* defaulting to the window."""
    _n = 0
    _type = ""

    def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                 ceil_mode=False, count_include_pad=None, **kwargs):
        n = self._n
        super().__init__(_tup(pool_size, n),
                         None if strides is None else _tup(strides, n),
                         _tup(padding, n), ceil_mode, False, self._type,
                         count_include_pad, **kwargs)


class _AvgPooling(_WindowPooling):
    _type = "avg"

    def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(pool_size, strides, padding, layout, ceil_mode,
                         count_include_pad, **kwargs)


class MaxPool1D(_WindowPooling):
    _n, _type = 1, "max"


class MaxPool2D(_WindowPooling):
    _n, _type = 2, "max"


class MaxPool3D(_WindowPooling):
    _n, _type = 3, "max"


class AvgPool1D(_AvgPooling):
    _n = 1


class AvgPool2D(_AvgPooling):
    _n = 2


class AvgPool3D(_AvgPooling):
    _n = 3


class _GlobalPooling(_Pooling):
    _n = 0
    _type = ""

    def __init__(self, layout=None, **kwargs):
        super().__init__((1,) * self._n, None, (0,) * self._n, True, True,
                         self._type, **kwargs)


class GlobalMaxPool1D(_GlobalPooling):
    _n, _type = 1, "max"


class GlobalMaxPool2D(_GlobalPooling):
    _n, _type = 2, "max"


class GlobalMaxPool3D(_GlobalPooling):
    _n, _type = 3, "max"


class GlobalAvgPool1D(_GlobalPooling):
    _n, _type = 1, "avg"


class GlobalAvgPool2D(_GlobalPooling):
    _n, _type = 2, "avg"


class GlobalAvgPool3D(_GlobalPooling):
    _n, _type = 3, "avg"
