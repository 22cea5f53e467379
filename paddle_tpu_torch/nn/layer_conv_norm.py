"""Convolution, normalisation and pooling layers — the counterpart of
``paddle_tpu/nn/layer_conv_norm.py``.

* ``Conv1D/2D/3D`` and their transposes: weight ``[out, in / groups, *k]``
  (``[in, out / groups, *k]`` for a transpose), JAX's default
  ``Normal(0, sqrt(2 / fan_in))`` (:39-44), bias 0. A channels-last conv
  (``data_format`` ending in C) keeps its weight's storage channels-last,
  so torch's channels-last kernels read it without a copy.
* ``_BatchNormBase`` (``BatchNorm``, ``BatchNorm1D/2D/3D``,
  ``SyncBatchNorm``): weight 1, bias 0, running mean 0 and variance 1 as
  float32 buffers ``_mean`` / ``_variance`` (persistable), momentum 0.9
  meaning "keep" as in paddle; ``forward_fused`` is JAX's fused
  residual-add and relu (:156-166). ``amp.decorate`` at O2 leaves these
  layers, and ``LayerNorm``, in their dtype. ``SyncBatchNorm`` takes its
  training statistics over the data-parallel group.
* ``GroupNorm``, ``InstanceNorm1D/2D/3D``, ``LocalResponseNorm``,
  ``LayerNorm``, ``RMSNorm``. (``SpectralNorm`` is in ``layer_extra``,
  where JAX's working one is.)
* The pools (:315-395).

``LayerNorm`` and ``RMSNorm`` keep the port's ``device`` / ``dtype``
arguments, which the torch-level models pass.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.device import get_place
from . import functional as F
from . import initializer as I
from .functional.norm import rms_norm
from .layer import Layer

__all__ = [
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
    "Conv3DTranspose", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
    "BatchNorm3D", "SyncBatchNorm", "LayerNorm", "RMSNorm", "rms_norm",
    "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
    "LocalResponseNorm", "MaxPool1D", "MaxPool2D",
    "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D", "AdaptiveAvgPool1D",
    "AdaptiveAvgPool2D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
    "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
]


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, weight_attr, bias_attr,
                 data_format, n, transpose=False, output_padding=0):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride = _ntuple(stride, n)
        self._padding = padding
        self._dilation = _ntuple(dilation, n)
        self._groups = groups
        self._data_format = data_format
        self._n = n
        self._output_padding = output_padding
        if transpose:
            shape = [in_channels, out_channels // groups, *self._kernel_size]
        else:
            shape = [out_channels, in_channels // groups, *self._kernel_size]
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        self.weight = self.create_parameter(
            shape, attr=weight_attr,
            default_initializer=I.Normal(0.0, (2.0 / fan_in) ** 0.5))
        if data_format.endswith("C") and n in (2, 3):
            fmt = (torch.channels_last if n == 2
                   else torch.channels_last_3d)
            w = self.weight._value
            w.data = w.data.contiguous(memory_format=fmt)
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  self._data_format, output_size)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  self._data_format, output_size)


# ------------------------------------------------------------ norm layers
class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        dev = (self.weight._value.device if self.weight is not None
               else get_place().device)
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    # the legacy ``BatchNorm``'s activation (kept by a converted one)
    _act = None

    def forward(self, x):
        out = self.forward_fused(x)
        return F.relu(out) if self._act == "relu" else out

    def _sync_group(self):
        """The process group whose rows the training statistics cover
        (``SyncBatchNorm``); None: this rank's rows."""
        return None

    def forward_fused(self, x, residual=None, act=None):
        """relu(bn(x) + residual) as one op (``residual`` / ``act``
        optional), its backward recomputing the epilogue (JAX :156-166)."""
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats, residual=residual,
            act=act, group=self._sync_group() if self.training else None)


class BatchNorm(_BatchNormBase):
    """paddle's legacy ``nn.BatchNorm`` (with ``act``)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats)
        self._act = act


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose training statistics are over every rank's rows of
    the data-parallel batch (Paddle ``SyncBatchNorm``; JAX's is
    ``BatchNorm`` under GSPMD, whose statistics span the sharded batch
    axis). In training over a group of more than one rank, each call
    all-gathers every rank's per-channel count, mean and sum of squared
    deviations once and combines them exactly, the running variance is
    unbiased by the global count, and the backward is that of the whole
    batch's normalisation (``F.batch_norm(group=)``). The group is the
    one of the ``DataParallel`` that wraps the layer, else the world when
    a process group is set; at one rank, or with none, the layer is
    ``BatchNorm`` bit for bit."""

    _group = None

    def _sync_group(self):
        if self._group is not None:
            return self._group
        from ..distributed import env
        from ..distributed.collective import _world

        return _world() if env.is_initialized() else None

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every ``_BatchNormBase`` sublayer of ``layer`` (or ``layer``
        itself) replaced by a ``SyncBatchNorm`` that holds the same
        parameters and buffers (Paddle's meaning; JAX returns the layer
        as it is, its two being one). Returns the converted layer."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            sync = cls.__new__(cls)
            sync.__dict__.update(layer.__dict__)
            return sync
        for name, child in list(layer._modules.items()):
            if child is not None:
                layer._modules[name] = cls.convert_sync_batchnorm(child)
        return layer


class LayerNorm(Layer):
    """Weight 1 and bias 0 over ``normalized_shape``, epsilon 1e-5 (JAX's
    defaults); ``weight_attr`` / ``bias_attr`` False drop the parameter."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            self.normalized_shape, attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            self.normalized_shape, attr=bias_attr, dtype=dtype, is_bias=True,
            device=device)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.weight is not None:
                self.weight._value.fill_(1.0)
            if self.bias is not None:
                self.bias._value.zero_()

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None,
                 device=None, dtype=None):
        super().__init__()
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.epsilon = epsilon

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm1D(Layer):
    _format = "NCL"

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format or self._format
        self.scale = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        fmt = "NCHW" if self._data_format == "NCL" else self._data_format
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon, data_format=fmt)


class InstanceNorm2D(InstanceNorm1D):
    _format = "NCHW"


class InstanceNorm3D(InstanceNorm1D):
    _format = "NCDHW"


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self._args)


# --------------------------------------------------------- pooling layers
def _pool_layer(fname, cls_name):
    fn = getattr(F, fname)

    class _Pool(Layer):
        def __init__(self, kernel_size=None, stride=None, padding=0,
                     **kwargs):
            super().__init__()
            self.kernel_size = kernel_size
            self.stride = stride
            self.padding = padding
            self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return fn(x, self.kernel_size, self.stride, self.padding,
                      **self.kwargs)

    _Pool.__name__ = _Pool.__qualname__ = cls_name
    _Pool.__doc__ = f"``nn.functional.{fname}`` as a layer."
    return _Pool


MaxPool1D = _pool_layer("max_pool1d", "MaxPool1D")
MaxPool2D = _pool_layer("max_pool2d", "MaxPool2D")
MaxPool3D = _pool_layer("max_pool3d", "MaxPool3D")
AvgPool1D = _pool_layer("avg_pool1d", "AvgPool1D")
AvgPool2D = _pool_layer("avg_pool2d", "AvgPool2D")
AvgPool3D = _pool_layer("avg_pool3d", "AvgPool3D")


def _adaptive_layer(fname, cls_name, default_format=None):
    """An adaptive pool layer: ``(output_size, data_format)`` when the
    functional takes a layout (``default_format``), else ``(output_size,
    return_mask)`` as JAX's signatures are."""
    fn = getattr(F, fname)

    class _Adaptive(Layer):
        def __init__(self, output_size, data_format=default_format,
                     name=None):
            super().__init__()
            self.output_size = output_size
            self.data_format = data_format

        def forward(self, x):
            if default_format is None:
                return fn(x, self.output_size)
            return fn(x, self.output_size, self.data_format)

    _Adaptive.__name__ = _Adaptive.__qualname__ = cls_name
    _Adaptive.__doc__ = f"``nn.functional.{fname}`` as a layer."
    return _Adaptive


AdaptiveAvgPool1D = _adaptive_layer("adaptive_avg_pool1d",
                                    "AdaptiveAvgPool1D")
AdaptiveAvgPool2D = _adaptive_layer("adaptive_avg_pool2d",
                                    "AdaptiveAvgPool2D", "NCHW")
AdaptiveAvgPool3D = _adaptive_layer("adaptive_avg_pool3d",
                                    "AdaptiveAvgPool3D", "NCDHW")
AdaptiveMaxPool1D = _adaptive_layer("adaptive_max_pool1d",
                                    "AdaptiveMaxPool1D")
AdaptiveMaxPool2D = _adaptive_layer("adaptive_max_pool2d",
                                    "AdaptiveMaxPool2D")
AdaptiveMaxPool3D = _adaptive_layer("adaptive_max_pool3d",
                                    "AdaptiveMaxPool3D")
