"""The ResNet family — the counterpart of
``paddle_tpu/vision/models/resnet.py``: ``BasicBlock``,
``BottleneckBlock``, ``ResNet`` (with ``data_format``) and the
constructors resnet18-152, the ResNeXt and the wide variants, built from
the port's nn layers. ``data_format="NHWC"`` builds the network
channels-last: the input is [N, H, W, C], and every convolution, batch
norm and pool works on channels-last memory (no layout copies)."""
from __future__ import annotations

from ...nn import (
    AdaptiveAvgPool2D,
    BatchNorm2D,
    Conv2D,
    Layer,
    Linear,
    MaxPool2D,
    ReLU,
    Sequential,
)

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d", "wide_resnet50_2", "wide_resnet101_2",
           "BasicBlock", "BottleneckBlock"]


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        df = {"data_format": data_format}
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, **df)
        self.bn1 = norm_layer(planes, **df)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **df)
        self.bn2 = norm_layer(planes, **df)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        df = {"data_format": data_format}
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **df)
        self.bn1 = norm_layer(width, **df)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation, bias_attr=False,
                            **df)
        self.bn2 = norm_layer(width, **df)
        self.conv3 = Conv2D(width, planes * self.expansion, 1, bias_attr=False,
                            **df)
        self.bn3 = norm_layer(planes * self.expansion, **df)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    """``data_format`` (beyond the reference constructor): "NHWC" builds the
    whole network channels-last; the input is then NHWC too."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW"):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        self.data_format = data_format
        df = {"data_format": data_format}

        self.conv1 = Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                            padding=3, bias_attr=False, **df)
        self.bn1 = self._norm_layer(self.inplanes, **df)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1, **df)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), **df)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        df = {"data_format": self.data_format}
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **df),
                norm_layer(planes * block.expansion, **df),
            )
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, self.dilation, norm_layer,
                        data_format=self.data_format)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer,
                                data_format=self.data_format))
        return Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            from ...ops.manipulation import flatten

            x = flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(arch, Block, depth, pretrained, **kwargs):
    model = ResNet(Block, depth, **kwargs)
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a converted state_dict "
            "with model.set_state_dict")
    return model


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet("wide_resnet50_2", BottleneckBlock, 50, pretrained,
                   **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet("wide_resnet101_2", BottleneckBlock, 101, pretrained,
                   **kwargs)


def _resnext(depth, groups, width, pretrained, **kwargs):
    # ResNeXt = bottleneck ResNet with grouped 3x3 convs; base_width is the
    # per-group width (reference: resnet.py resnext* constructors)
    kwargs["groups"] = groups
    kwargs["width"] = width
    return _resnet(f"resnext{depth}_{groups}x{width}d", BottleneckBlock,
                   depth, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, 4, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, 4, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, 4, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, 4, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, 4, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, 4, pretrained, **kwargs)
