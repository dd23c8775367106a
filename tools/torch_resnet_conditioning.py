#!/usr/bin/env python
"""How well conditioned paddle_tpu_torch's ResNet-50 step-1 gradient is.

The port only (no JAX), on the CPU by default.  One seeded model
(``init_params``), one seeded batch of ``rand`` images, fused NHWC route:

1. sensitivity: the float64 gradient after a relative change ``eps`` of
   the image (or of every weight), per ``eps``: the loss's and the
   gradients' relative change (median and worst over the tensors).  A
   smooth gradient moves in proportion to ``eps``; a ReLU or max that
   flips makes it jump.
2. precision: the f32 and the bf16 amp (``amp.enable``) gradients against
   float64 for each image kind: per tensor the relative distance, the
   cosine and |norm ratio - 1|, their median and worst.

    python tools/torch_resnet_conditioning.py [--size 64] [--batch 8]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch import ResNet, amp  # noqa: E402


def images(kind, batch, size, rng):
    img = rng.rand(batch, 3, size, size)
    if kind == "contrast":  # each image its own gain and offset
        img = (img * rng.uniform(0.1, 2.0, (batch, 1, 1, 1))
               + rng.uniform(-1, 1, (batch, 1, 1, 1)))
    elif kind == "smooth":  # a 4 x 4 pattern upsampled, a little noise
        grid = torch.from_numpy(rng.randn(batch, 3, 4, 4))
        img = torch.nn.functional.interpolate(
            grid, size=(size, size), mode="bilinear",
            align_corners=False).numpy() + 0.1 * img
    return torch.from_numpy(img)


def gradients(state, image, label, dtype, use_amp=False, weight_eps=0.0):
    model = ResNet(50, 16, device="cpu").to(dtype)
    model.load_state_dict(state)
    if weight_eps:
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + weight_eps * torch.randn(
                    p.shape, generator=gen, dtype=dtype))
    if use_amp:
        amp.enable(model)
    loss, _, _ = model(image.to(dtype), label)
    loss.backward()
    return loss.item(), {n: p.grad.double() for n, p in
                         model.named_parameters()}


def summary(values):
    return f"median {np.median(values):.3g} worst {max(values):.3g}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.RandomState(args.seed)
    label = torch.from_numpy(rng.randint(0, 16, (args.batch, 1)))
    state = ResNet(50, 16, device="cpu").init_params(args.seed).state_dict()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731

    image = images("rand", args.batch, args.size, rng)
    loss0, g0 = gradients(state, image, label, torch.float64)
    noise = torch.from_numpy(np.random.RandomState(3).randn(*image.shape))
    for eps in (1e-12, 1e-10, 1e-9, 1e-8):
        loss, g = gradients(state, image * (1 + eps * noise), label,
                            torch.float64)
        _, gw = gradients(state, image, label, torch.float64,
                          weight_eps=eps)
        print(f"sensitivity eps {eps:g}: image: loss "
              f"{abs(loss - loss0) / loss0:.3g}, gradients "
              f"{summary([rel(g[n], g0[n]) for n in g0])}; weights: "
              f"gradients {summary([rel(gw[n], g0[n]) for n in g0])}")

    for kind in ("rand", "contrast", "smooth"):
        image = images(kind, args.batch, args.size,
                       np.random.RandomState(args.seed + 1))
        loss64, g64 = gradients(state, image, label, torch.float64)
        for tag, dtype, use_amp in (("f32", torch.float32, False),
                                    ("amp", torch.float32, True)):
            loss, g = gradients(state, image, label, dtype, use_amp)
            cos = [(g[n].flatten() @ g64[n].flatten()
                    / (g[n].norm() * g64[n].norm())).item() for n in g64]
            norm = [abs(g[n].norm().item() / g64[n].norm().item() - 1)
                    for n in g64]
            print(f"{kind} {tag} ({args.size} x {args.size}, batch "
                  f"{args.batch}): loss {abs(loss - loss64) / loss64:.3g} "
                  f"off float64; distance "
                  f"{summary([rel(g[n], g64[n]) for n in g64])}; cosine "
                  f"median {np.median(cos):.3g} least {min(cos):.3g}; "
                  f"|norm ratio - 1| {summary(norm)}")


if __name__ == "__main__":
    main()
