"""The paper's own benchmark networks (DeepOBS, Table 3) as module trees.

LogReg (MNIST), MLP, 2C2D (F-MNIST), 3C3D (CIFAR-10), All-CNN-C (CIFAR-100).
Port of ``src/repro/configs/papernets.py``.  Every constructor takes the
device (the card unless the caller asks for the CPU) and an optional CPU
``torch.Generator`` for the random initialization; the parity tests copy the
JAX package's weights in instead (:mod:`repro_torch.bridge`).
"""
from __future__ import annotations

from repro_torch.core.module import Activation, Dense, Module, Sequential
from repro_torch.nn.layers import Conv2d, Flatten, MaxPool2d


def logreg(n_classes=10, in_dim=784, device="cuda", generator=None):
    return Sequential([Dense(in_dim, n_classes, device=device, generator=generator)])


def mlp(n_classes=10, in_dim=784, hidden=(128, 64), act="sigmoid",
        device="cuda", generator=None):
    mods = []
    d = in_dim
    for h in hidden:
        mods += [Dense(d, h, device=device, generator=generator), Activation(act)]
        d = h
    mods.append(Dense(d, n_classes, device=device, generator=generator))
    return Sequential(mods)


def c2d2(n_classes=10, in_ch=1, img=28, device="cuda", generator=None):
    """2 conv + 2 dense (the paper's 2C2D, scaled by `img`)."""
    kw = dict(device=device, generator=generator)
    after = img // 4
    return Sequential([
        Conv2d(in_ch, 32, kernel=5, padding="SAME", **kw), Activation("relu"),
        MaxPool2d(2),
        Conv2d(32, 64, kernel=5, padding="SAME", **kw), Activation("relu"),
        MaxPool2d(2),
        Flatten(),
        Dense(after * after * 64, 256, **kw), Activation("relu"),
        Dense(256, n_classes, **kw),
    ])


def c3d3(n_classes=10, in_ch=3, img=32, device="cuda", generator=None):
    """3 conv + 3 dense (the paper's 3C3D on CIFAR-10)."""
    kw = dict(device=device, generator=generator)
    after = img // 8
    return Sequential([
        Conv2d(in_ch, 64, kernel=5, padding="SAME", **kw), Activation("relu"),
        MaxPool2d(2),
        Conv2d(64, 96, kernel=3, padding="SAME", **kw), Activation("relu"),
        MaxPool2d(2),
        Conv2d(96, 128, kernel=3, padding="SAME", **kw), Activation("relu"),
        MaxPool2d(2),
        Flatten(),
        Dense(after * after * 128, 512, **kw), Activation("relu"),
        Dense(512, 256, **kw), Activation("relu"),
        Dense(256, n_classes, **kw),
    ])


def allcnnc(n_classes=100, in_ch=3, img=32, width=96, device="cuda",
            generator=None):
    """All-CNN-C (Springenberg 2015): 9 conv layers, no dense."""
    kw = dict(device=device, generator=generator)
    w2 = 2 * width
    return Sequential([
        Conv2d(in_ch, width, 3, **kw), Activation("relu"),
        Conv2d(width, width, 3, **kw), Activation("relu"),
        Conv2d(width, width, 3, stride=2, **kw), Activation("relu"),
        Conv2d(width, w2, 3, **kw), Activation("relu"),
        Conv2d(w2, w2, 3, **kw), Activation("relu"),
        Conv2d(w2, w2, 3, stride=2, **kw), Activation("relu"),
        Conv2d(w2, w2, 3, padding="VALID", **kw), Activation("relu"),
        Conv2d(w2, w2, 1, **kw), Activation("relu"),
        Conv2d(w2, n_classes, 1, **kw),
        GlobalAvgPool(),
    ])


class GlobalAvgPool(Module):
    """Mean over the spatial axes of an NHWC input; the tape is its shape."""

    def call(self, params, x):
        return x.mean(dim=(1, 2))

    def forward_tape(self, params, x):
        return self.call(params, x), tuple(x.shape)

    def jac_t_mat(self, params, tape, M):
        n, h, w, c = tape
        return (M[:, :, None, None, :] / (h * w)).expand((M.shape[0],) + tape).contiguous()

    def backward(self, params, tape, g, exts, cfg):
        return self.jac_t_mat(params, tape, g[None])[0], (), ()

    def curv_backward(self, params, tape, S, exts, cfg, ext_prefix):
        return self.jac_t_mat(params, tape, S), ()
