"""Core layers — the counterpart of ``paddle_tpu/nn/layer_common.py``:
Linear, Embedding, the dropouts, Flatten, Identity, the upsamplers,
PixelShuffle, Bilinear, the pads, CosineSimilarity, the containers
(Sequential, LayerList, ParameterList, LayerDict) and the activation
layers. Each is a ``Layer`` over the functional of the same name; the
dropouts take ``training`` from the layer's mode.

``Linear.weight`` is paddle's [in, out] (torch's is [out, in]).
``Embedding`` keeps the port's ``device`` / ``dtype`` arguments and
``reset_parameters(generator)``, which the torch-level models call.
"""
from __future__ import annotations

import torch

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = [
    "Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
    "AlphaDropout", "Flatten", "Identity", "Upsample",
    "UpsamplingBilinear2D", "UpsamplingNearest2D", "PixelShuffle",
    "Bilinear", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D", "CosineSimilarity",
    "Sequential", "LayerList", "ParameterList", "LayerDict", "ReLU", "ReLU6",
    "ELU", "SELU", "CELU", "GELU", "Silu", "Swish", "Sigmoid", "Hardsigmoid",
    "Hardswish", "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink",
    "LeakyReLU", "LogSigmoid", "LogSoftmax", "Softmax", "Softplus",
    "Softsign", "Mish", "Tanh", "ThresholdedReLU", "Maxout", "GLU", "PReLU",
    "RReLU",
]


class Linear(Layer):
    """y = x W + b; W [in_features, out_features], Xavier-uniform; b 0."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    """A [num_embeddings, embedding_dim] table, Xavier-normal (JAX :40-52);
    the ``padding_idx`` row (negative counts from the end) starts at 0 and
    always looks up as 0."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None,
                 dtype=None):
        super().__init__()
        self.padding_idx = (None if padding_idx is None else
                            padding_idx if padding_idx >= 0
                            else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr, dtype=dtype,
            default_initializer=I.XavierNormal(), device=device)
        self._zero_padding_row()

    def _zero_padding_row(self):
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight._value[self.padding_idx] = 0

    def reset_parameters(self, generator=None):
        torch.nn.init.xavier_normal_(self.weight._value, generator=generator)
        self._zero_padding_row()

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ..ops.manipulation import flatten

        return flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self._args = (size, scale_factor, mode, align_corners, align_mode,
                      data_format)

    def forward(self, x):
        return F.interpolate(x, *self._args)


class UpsamplingBilinear2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._args = (size, scale_factor, data_format)

    def forward(self, x):
        size, sf, fmt = self._args
        return F.interpolate(x, size, sf, mode="bilinear",
                             align_corners=True, data_format=fmt)


class UpsamplingNearest2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._args = (size, scale_factor, data_format)

    def forward(self, x):
        size, sf, fmt = self._args
        return F.interpolate(x, size, sf, mode="nearest", data_format=fmt)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter([1, out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class _Pad(Layer):
    _format = "NCHW"

    def __init__(self, padding, mode="constant", value=0.0, data_format=None,
                 name=None):
        super().__init__()
        self._args = (padding, mode, value, data_format or self._format)

    def forward(self, x):
        p, m, v, fmt = self._args
        return F.pad(x, p, mode=m, value=v,
                     data_format="NCW" if fmt == "NCL" else fmt)


class Pad1D(_Pad):
    _format = "NCL"


class Pad2D(_Pad):
    _format = "NCHW"


class Pad3D(_Pad):
    _format = "NCDHW"


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self._args = (padding, data_format)

    def forward(self, x):
        return F.zeropad2d(x, *self._args)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


# ------------------------------------------------------------ containers
class Sequential(Layer):
    """Sublayers "0", "1", ... (or the names of (name, layer) pairs), each
    fed the previous one's output."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, (list, tuple)):
                self.add_sublayer(str(layer[0]), layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def extend(self, sublayers):
        for layer in sublayers:
            self.append(layer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for layer in layers:
            self.append(layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return LayerList(layers[idx])
        return layers[idx]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx % len(self._modules)), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return getattr(self, str(idx % len(self._parameters)))

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return (getattr(self, k) for k in list(self._parameters))


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def update(self, sublayers):
        items = (sublayers.items() if isinstance(sublayers, dict)
                 else sublayers)
        for k, v in items:
            self.add_sublayer(k, v)


# ------------------------------------------------------ activation layers
def _act_layer(fname, cls_name):
    fn = getattr(F, fname)

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._args = args
            self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return fn(x, *self._args, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = cls_name
    _Act.__doc__ = f"``nn.functional.{fname}`` as a layer."
    return _Act


ReLU = _act_layer("relu", "ReLU")
ReLU6 = _act_layer("relu6", "ReLU6")
ELU = _act_layer("elu", "ELU")
SELU = _act_layer("selu", "SELU")
CELU = _act_layer("celu", "CELU")
GELU = _act_layer("gelu", "GELU")
Silu = _act_layer("silu", "Silu")
Swish = _act_layer("swish", "Swish")
Sigmoid = _act_layer("sigmoid", "Sigmoid")
Hardsigmoid = _act_layer("hardsigmoid", "Hardsigmoid")
Hardswish = _act_layer("hardswish", "Hardswish")
Hardtanh = _act_layer("hardtanh", "Hardtanh")
Hardshrink = _act_layer("hardshrink", "Hardshrink")
Softshrink = _act_layer("softshrink", "Softshrink")
Tanhshrink = _act_layer("tanhshrink", "Tanhshrink")
LeakyReLU = _act_layer("leaky_relu", "LeakyReLU")
LogSigmoid = _act_layer("log_sigmoid", "LogSigmoid")
LogSoftmax = _act_layer("log_softmax", "LogSoftmax")
Softmax = _act_layer("softmax", "Softmax")
Softplus = _act_layer("softplus", "Softplus")
Softsign = _act_layer("softsign", "Softsign")
Mish = _act_layer("mish", "Mish")
Tanh = _act_layer("tanh", "Tanh")
ThresholdedReLU = _act_layer("thresholded_relu", "ThresholdedReLU")
Maxout = _act_layer("maxout", "Maxout")
GLU = _act_layer("glu", "GLU")


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1 / 8.0, upper=1 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)
