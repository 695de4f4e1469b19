"""HGAM: the fracture classifier and its Grad-CAM++ heatmaps.

Counterpart of healthivert_tpu/models/hgam.py:29-107: a conv encoder of
four 3x3 stride-2 convs (width w, 2w, 4w, 4w), each with GroupNorm(8) and
ReLU, global average pooling and a 2-class head (normal / fractured), on
NHWC input; Grad-CAM++ over its last conv features; the cross-entropy and
one Adam step.

Flax's conventions kept here: GroupNorm's epsilon is 1e-6 (torch's default
is 1e-5), and the init draws every kernel from flax's lecun normal (a
normal truncated at two standard deviations, std sqrt(1 / fan_in) /
0.8796), with zero biases, GroupNorm scales 1 and biases 0, from an
explicit `torch.Generator`. The JAX package's weights come across through
`utils.weights.flax_classifier_to_state_dict`.

Grad-CAM++ (Chattopadhay et al., 2018), closed form on the logit gradient g
at the features A:
  alpha = g^2 / (2 g^2 + sum_ij A g^3),  w_k = sum_ij alpha relu(g),
  cam = relu(sum_k w_k A_k), divided by its per-sample max, resized to the
  input's height and width.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.image import resize_nearest

GN_EPS = 1e-6
# the std of a standard normal truncated to [-2, 2] (flax's lecun_normal)
TRUNC_STD = 0.87962566103423978


class FractureClassifier(nn.Module):
    """Conv encoder -> GAP -> 2-class logits. Input (B, H, W, in_ch) in
    [-1, 1]."""

    def __init__(self, width: int = 32, in_ch: int = 1):
        super().__init__()
        chans = [in_ch, width, width * 2, width * 4, width * 4]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1) for i in range(4))
        self.norms = nn.ModuleList(
            nn.GroupNorm(8, chans[i + 1], eps=GN_EPS) for i in range(4))
        self.fc = nn.Linear(width * 4, 2)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in) -> (B, H/16, W/16, 4w)."""
        x = x.permute(0, 3, 1, 2)
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(norm(conv(x)))
        return x.permute(0, 2, 3, 1)

    def head(self, feats: torch.Tensor) -> torch.Tensor:
        return self.fc(feats.mean(dim=(1, 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))


def init_classifier(model: FractureClassifier, generator: torch.Generator) -> FractureClassifier:
    """Flax's initialisation, drawn from `generator`: lecun-normal kernels,
    zero biases, GroupNorm scale 1 and bias 0."""
    with torch.no_grad():
        for mod in list(model.convs) + [model.fc]:
            w = mod.weight
            fan_in = w.shape[1] * (w.shape[2] * w.shape[3] if w.ndim == 4 else 1)
            std = math.sqrt(1.0 / fan_in) / TRUNC_STD
            t = torch.empty(w.shape)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.copy_(t * std)
            mod.bias.zero_()
        for norm in model.norms:
            norm.weight.fill_(1.0)
            norm.bias.zero_()
    return model


def grad_cam_pp(model: FractureClassifier, x: torch.Tensor, target_class: int = 1) -> torch.Tensor:
    """Grad-CAM++ heatmaps of a batch of slices: x (B, H, W, C) in [-1, 1]
    -> (B, H, W, 1) in [0, 1]."""
    with torch.enable_grad():
        feats = model.features(x).detach().requires_grad_(True)
        score = model.head(feats)[:, target_class].sum()
        (g,) = torch.autograd.grad(score, feats)
    feats = feats.detach()
    g2 = g * g
    g3 = g2 * g
    denom = 2.0 * g2 + torch.sum(feats * g3, dim=(1, 2), keepdim=True)
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    alpha = g2 / denom
    w = torch.sum(alpha * F.relu(g), dim=(1, 2), keepdim=True)  # (B, 1, 1, C)
    cam = F.relu(torch.sum(w * feats, dim=-1, keepdim=True))  # (B, h, w, 1)
    cam = cam / (torch.amax(cam, dim=(1, 2, 3), keepdim=True) + 1e-8)
    return resize_nearest(cam, x.shape[1], x.shape[2])


def classifier_loss(model: FractureClassifier, batch_x: torch.Tensor, batch_y: torch.Tensor):
    """(mean cross-entropy, batch accuracy)."""
    logits = model(batch_x)
    ce = -torch.mean(torch.sum(F.one_hot(batch_y, 2) * F.log_softmax(logits, dim=-1), dim=-1))
    acc = torch.mean((torch.argmax(logits, -1) == batch_y).float())
    return ce, acc


def make_optimizer(model: FractureClassifier) -> torch.optim.Adam:
    """optax.scale_by_adam() followed by a -lr scale: Adam with betas (0.9,
    0.999), eps 1e-8 outside the square root, bias-corrected; the lr is
    set per step by `classifier_train_step`."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def classifier_train_step(model: FractureClassifier, opt: torch.optim.Adam,
                          batch_x: torch.Tensor, batch_y: torch.Tensor, lr: float):
    """One Adam step at learning rate `lr`; returns (loss, accuracy) as
    tensors on the model's device."""
    for group in opt.param_groups:
        group["lr"] = float(lr)
    opt.zero_grad(set_to_none=True)
    loss, acc = classifier_loss(model, batch_x, batch_y)
    loss.backward()
    opt.step()
    return loss.detach(), acc.detach()
