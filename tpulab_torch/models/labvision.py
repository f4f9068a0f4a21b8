"""labvision, the convolutional classifier of the lab suite's image domain,
on PyTorch (the counterpart of ``tpulab.models.labvision``, one device).

A stack of 3x3 stride-2 convolutions with GELU, a global average pool and a
linear head learns the lab3 task family: which Gaussian colour class
produced an image (:func:`synth_batch`, a copy of ``tpulab``'s generator).

``tpulab`` computes in NHWC with HWIO weights; the port keeps the weights
as ``F.conv2d`` takes them (OIHW, ``channels_last`` on the card) and feeds
it the images as an NCHW view of the NHWC batch, which is the
``channels_last`` layout, so no layout change runs inside the step.  The
optimizer, the checkpoint and :meth:`Labvision.to_numpy` see the weights
as HWIO views, ``tpulab``'s tree.  ``padding="SAME"`` at stride 2 pads
``total // 2`` before and the rest after each spatial axis (0 and 1 on an
even side), which ``F.conv2d``'s symmetric padding cannot express, so the
input is padded with ``F.pad``; ``jax.nn.gelu`` is the tanh form.  The
compute dtype follows ``tpulab``'s rule with the card in the TPU's place:
bfloat16 on the card, float32 on the host, ``cfg.dtype`` overriding; uint8
images are normalised in float32 and then cast.

The convolutions are ``F.conv2d`` (cuDNN on the card), the counterpart of
``tpulab``'s ``lax.conv_general_dilated``, which no Pallas kernel computes:
the model launches none of kernels B1-B7.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpulab_torch import optim
from tpulab_torch.models.labformer import _flat, _leaf_sizes
from tpulab_torch.parallel import spmd
from tpulab_torch.parallel.mesh import mesh_anchor, mesh_shape
from tpulab_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LabvisionConfig:
    n_classes: int = 8
    img_size: int = 32          # square input, NHWC
    channels: Tuple[int, ...] = (32, 64, 128)  # per stage, stride 2 each
    dtype: Optional[torch.dtype] = None  # bf16 on the card, f32 on the host


def compute_dtype(cfg: LabvisionConfig, device) -> torch.dtype:
    if cfg.dtype is not None:
        return cfg.dtype
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def init_params(cfg: LabvisionConfig, seed: int = 0) -> Dict[str, Any]:
    """``tpulab``'s He-initialised tree (HWIO conv weights, float32 CPU
    tensors): the same numpy draws in the same order, rounded once."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {"convs": [], "head": None}
    c_in = 3
    for c_out in cfg.channels:
        fan_in = 3 * 3 * c_in
        params["convs"].append({
            "w": torch.from_numpy(rng.standard_normal((3, 3, c_in, c_out))
                                  * np.sqrt(2.0 / fan_in)).to(torch.float32),
            "b": torch.zeros((c_out,), dtype=torch.float32),
        })
        c_in = c_out
    params["head"] = {
        "w": torch.from_numpy(rng.standard_normal((c_in, cfg.n_classes))
                              * np.sqrt(1.0 / c_in)).to(torch.float32),
        "b": torch.zeros((cfg.n_classes,), dtype=torch.float32),
    }
    return params


def _tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))


def _same_pad(side: int) -> Tuple[int, int]:
    """``padding="SAME"`` of a 3x3 stride-2 window: (before, after)."""
    out = -(-side // 2)
    total = max((out - 1) * 2 + 3 - side, 0)
    return total // 2, total - total // 2


class Labvision(nn.Module):
    """The classifier on one device: ``forward(images)`` gives float32
    logits for (b, H, W, 3) uint8 or float images."""

    def __init__(self, params: Dict[str, Any], cfg: LabvisionConfig,
                 device: Optional[Union[str, torch.device]] = None, trainable: bool = False):
        super().__init__()
        device = resolve_device(device) if device is None or isinstance(device, str) \
            else torch.device(device)
        self.cfg = cfg
        fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format

        def param(t, **kw):
            return nn.Parameter(t.to(device).contiguous(**kw), requires_grad=trainable)

        self.conv_w = nn.ParameterList(
            param(_tensor(c["w"]).permute(3, 2, 0, 1), memory_format=fmt)
            for c in params["convs"])  # HWIO -> OIHW
        self.conv_b = nn.ParameterList(param(_tensor(c["b"])) for c in params["convs"])
        self.head_w = param(_tensor(params["head"]["w"]))
        self.head_b = param(_tensor(params["head"]["b"]))

    @classmethod
    def from_numpy(cls, params: Dict[str, Any], cfg: LabvisionConfig,
                   device: Optional[Union[str, torch.device]] = None,
                   trainable: bool = False) -> "Labvision":
        """The module from ``tpulab``'s parameter tree (HWIO conv weights),
        on ``device`` (the card unless ``"cpu"``)."""
        return cls(params, cfg, device, trainable)

    @property
    def device(self) -> torch.device:
        return self.head_w.device

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.cfg, self.device)

    def named_leaves(self) -> List[Tuple[str, List[torch.Tensor]]]:
        """``(path, [tensor])`` of every leaf in ``tpulab``'s flattened tree
        order, the conv weights as HWIO views of the parameters."""
        out: List[Tuple[str, List[torch.Tensor]]] = []
        for i, (w, b) in enumerate(zip(self.conv_w, self.conv_b)):
            out += [(f"convs/{i}/b", [b]), (f"convs/{i}/w", [w.permute(2, 3, 1, 0)])]
        return out + [("head/b", [self.head_b]), ("head/w", [self.head_w])]

    def trainable_leaves(self) -> List[Tuple[str, List[torch.Tensor]]]:
        return [(n, ts) for n, ts in self.named_leaves() if ts[0].requires_grad]

    def grad_leaves(self) -> List[torch.Tensor]:
        """The gradients of :meth:`trainable_leaves`, in their order and
        layout (HWIO views for the conv weights)."""
        grads = []
        for i, (w, b) in enumerate(zip(self.conv_w, self.conv_b)):
            grads += [b.grad, w.grad.permute(2, 3, 1, 0)]
        return grads + [self.head_b.grad, self.head_w.grad]

    def to_tree(self, grads: bool = False) -> Dict[str, torch.Tensor]:
        """``{path: CPU tensor}`` (detached copies; HWIO conv weights), the
        parameters or, with ``grads``, their gradients."""
        with torch.no_grad():
            if grads:
                names = [n for n, _ in self.named_leaves()]
                return {n: g.detach().cpu().contiguous()
                        for n, g in zip(names, self.grad_leaves())}
            return {n: ts[0].detach().cpu().contiguous() for n, ts in self.named_leaves()}

    def to_numpy(self, grads: bool = False) -> Dict[str, Any]:
        """:meth:`to_tree` nested as ``tpulab``'s tree, numpy leaves."""
        flat = {k: v.numpy() for k, v in self.to_tree(grads).items()}
        return {"convs": [{"w": flat[f"convs/{i}/w"], "b": flat[f"convs/{i}/b"]}
                          for i in range(len(self.conv_w))],
                "head": {"w": flat["head/w"], "b": flat["head/b"]}}

    def images(self, images) -> torch.Tensor:
        return torch.as_tensor(images).to(self.device, non_blocking=True)

    def forward(self, images) -> torch.Tensor:
        """(b, H, W, 3) uint8/float images -> (b, n_classes) float32 logits."""
        dt = self.dtype
        x = self.images(images)
        # normalise in float32, then cast, as tpulab does
        x = (x.float() / 255.0).to(dt) if x.dtype == torch.uint8 else x.to(dt)
        x = x.permute(0, 3, 1, 2)  # NHWC batch as an NCHW (channels_last) view
        for w, b in zip(self.conv_w, self.conv_b):
            (top, bottom), (left, right) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.conv2d(F.pad(x, (left, right, top, bottom)), w.to(dt), stride=2)
            x = F.gelu(x + b.to(dt)[:, None, None], approximate="tanh")
        x = x.mean(dim=(2, 3))  # global average pool -> (b, C)
        return (x @ self.head_w.to(dt) + self.head_b.to(dt)).float()

    def loss_fn(self, images, labels) -> torch.Tensor:
        logp = torch.log_softmax(self(images), dim=-1)
        labels = torch.as_tensor(labels).to(self.device, non_blocking=True).long()
        return -torch.gather(logp, -1, labels[:, None]).mean()


def make_train_step(cfg: LabvisionConfig, optimizer: Optional[optim.Transform] = None,
                    mesh=None):
    """``(optimizer, step)``: ``step(model, opt_state, images, labels) ->
    (model, opt_state, loss)`` on a trainable :class:`Labvision`, the
    counterpart of ``tpulab``'s ``make_train_step`` (default
    ``optim.adamw(1e-3)``); the update is applied in place, through the
    HWIO views, and ``loss`` is a device scalar.

    With a ``mesh`` (its ``dp`` axis; ``tpulab/models/labvision.py:104-143``)
    every rank is given the whole batch and takes its dp rows; the
    parameters are replicated, each rank's loss is its rows' share of the
    global mean, and the gradients are summed over dp (the model keeps no
    batch statistics, so nothing else crosses the ranks)."""
    optimizer = optimizer or optim.adamw(1e-3)
    dp = None
    if mesh is not None:
        if mesh_shape(mesh).get("dp", 1) > 1:
            dp = spmd.mesh_axis(mesh, "dp")

    def step(model: Labvision, opt_state, images, labels):
        leaves = _flat(model)
        for p in model.parameters():
            p.grad = None
        if dp is None:
            loss = model.loss_fn(images, labels)
            loss.backward()
        else:
            loss = _dp_backward(model, images, labels, dp)
        with torch.no_grad():
            optim.apply_updates(leaves, optimizer.update(model.grad_leaves(), opt_state, leaves))
        return model, opt_state, loss.detach()

    return optimizer, step


def _dp_backward(model: Labvision, images, labels, dp) -> torch.Tensor:
    """This dp rank's rows: their share of the global mean loss, its
    backward, and the gradients summed over dp; the global loss."""
    b = len(labels)
    if b % dp.p:
        raise ValueError(f"batch {b} not divisible by dp={dp.p}")
    rows = slice(dp.idx * (b // dp.p), (dp.idx + 1) * (b // dp.p))
    logp = torch.log_softmax(model(torch.as_tensor(images)[rows]), dim=-1)
    labels = torch.as_tensor(labels)[rows].to(model.device, non_blocking=True).long()
    objective = -torch.gather(logp, -1, labels[:, None]).sum() / b
    objective.backward()
    with torch.no_grad():
        spmd.all_reduce_buckets([(p.grad, ("dp",)) for p in model.parameters()
                                 if p.grad is not None], {"dp": dp})
        return spmd.all_reduce_(objective.detach().clone(), dp)


def init_train_state(cfg: LabvisionConfig, seed: int = 0,
                     optimizer: Optional[optim.Transform] = None,
                     device: Optional[Union[str, torch.device]] = None, mesh=None):
    """``(model, opt_state, step)`` from :func:`init_params` (``seed``) on
    ``device`` (the card unless ``"cpu"``; with a ``mesh``, this rank's
    device), the step of :func:`make_train_step`."""
    optimizer, step = make_train_step(cfg, optimizer, mesh)
    if mesh is not None:
        device = mesh_anchor(mesh)
    model = Labvision.from_numpy(init_params(cfg, seed), cfg, device, trainable=True)
    return model, optimizer.init(_flat(model), _leaf_sizes(model)), step


def synth_batch(cfg: LabvisionConfig, batch: int, rng: np.random.Generator,
                spread: float = 24.0):
    """The lab3 generative model as a classification dataset (a copy of
    ``tpulab``'s): class c is N(mu_c, spread^2 I) in RGB; an image is
    class-coloured noise, its label the class."""
    mus = class_color_means(cfg)
    labels = rng.integers(0, cfg.n_classes, batch)
    noise = rng.standard_normal((batch, cfg.img_size, cfg.img_size, 3)) * spread
    images = np.clip(mus[labels][:, None, None, :] + noise, 0, 255).astype(np.uint8)
    return images, labels.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _color_means_cached(n_classes: int) -> tuple:
    rng = np.random.default_rng(1234)
    return tuple(map(tuple, rng.uniform(30, 225, size=(n_classes, 3))))


def class_color_means(cfg: LabvisionConfig) -> np.ndarray:
    """Deterministic per-class RGB means, well separated in [30, 225]."""
    return np.asarray(_color_means_cached(cfg.n_classes), np.float64)


@torch.no_grad()
def accuracy(model: Labvision, images, labels) -> float:
    pred = model(images).argmax(dim=-1).cpu().numpy()
    return float((pred == np.asarray(labels)).mean())
