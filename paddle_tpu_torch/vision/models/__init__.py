"""paddle.vision.models of the port: the ResNet family
(``paddle_tpu/vision/models/resnet.py``); the other families wait
(ROADMAP A11)."""
from .resnet import *  # noqa: F401,F403
from .resnet import __all__
