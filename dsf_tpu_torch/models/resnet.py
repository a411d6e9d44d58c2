"""ResNet blocks (counterpart of dsf_tpu/models/resnet.py; ref:
model/resnet.py:18-98), with the reference's module names (conv1..3,
bn1..3, downsample.{0,1}), so a reference state dict of any depth loads
by name.  The residual add runs in the activations' type, the compute
dtype, as in the JAX package."""

from __future__ import annotations

from torch import nn

from dsf_tpu_torch.models.layers import batch_norm, conv


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride, 1)
        self.bn1 = batch_norm(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = batch_norm(planes)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                conv(in_planes, planes * self.expansion, 1, stride, 0),
                batch_norm(planes * self.expansion))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 conv to ``planes``, 3x3 conv with the block's stride, 1x1 conv
    to ``planes * 4``, each followed by BatchNorm (ReLU after the first
    two), then ``+ identity`` and ReLU."""
    expansion = 4

    def __init__(self, in_planes, planes, stride=1, downsample=False):
        super().__init__()
        width = planes * self.expansion
        self.conv1 = conv(in_planes, planes, 1, 1, 0)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv(planes, width, 1, 1, 0)
        self.bn3 = batch_norm(width)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                conv(in_planes, width, 1, stride, 0), batch_norm(width))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


RESNET_SPECS = {
    18: (BasicBlock, [2, 2, 2, 2]),
    50: (Bottleneck, [3, 4, 6, 3]),
    101: (Bottleneck, [3, 4, 23, 3]),
    152: (Bottleneck, [3, 8, 36, 3]),
}


def res_layer(block, in_planes, planes, blocks, stride=1):
    """A _make_layer stage (ref: backbone.py:269-282): the first block may
    downsample or change width, the rest are plain.  Keys: ``{i}.*``."""
    need_down = stride != 1 or in_planes != planes * block.expansion
    layers = [block(in_planes, planes, stride, need_down)]
    layers += [block(planes * block.expansion, planes)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)
