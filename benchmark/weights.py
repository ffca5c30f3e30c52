"""Network weights from the run's seed, made on the device in one draw.

Every weight and bias of every net is cut from one buffer of standard
normals truncated to [-2, 2], drawn by a ``torch.Generator`` on the run's
device: weights scaled by Glorot's sqrt(2/(fan_in + fan_out)) (the
reference project's ``xavier_init``), biases by 0.1, so that no stream of
the jets starts degenerate.  Nets are drawn in sorted order of their names,
layer by layer, W before b.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Net = List[Tuple[torch.Tensor, torch.Tensor]]


def make(nets: Dict[str, Sequence[int]], seed: int, device: torch.device,
         dtype=torch.float32) -> Dict[str, Net]:
    shapes = [(fi, fo) for name in sorted(nets)
              for fi, fo in zip(nets[name][:-1], nets[name][1:])]
    total = sum(fi * fo + fo for fi, fo in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    buf = torch.empty(total, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(buf, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    out, i = {}, 0
    for name in sorted(nets):
        layers = []
        for fi, fo in zip(nets[name][:-1], nets[name][1:]):
            w = buf[i:i + fi * fo].view(fi, fo) * math.sqrt(2.0 / (fi + fo))
            i += fi * fo
            b = buf[i:i + fo] * 0.1
            i += fo
            layers.append((w.contiguous(), b.contiguous()))
        out[name] = layers
    return out


def program_tree(net: Net) -> list:
    """A net in the program's layout: a list of ``{"W", "b"}`` dicts."""
    return [{"W": w, "b": b} for w, b in net]


def unflat(vec: torch.Tensor, like: Net) -> Net:
    """A vector of a net's leaves, layer by layer, W before b (the order of
    the program's parameter trees: dict keys sorted, lists in order), as
    the net's (W, b) views."""
    out, i = [], 0
    for w, b in like:
        nw, nb = w.numel(), b.numel()
        out.append((vec[i:i + nw].view(w.shape), vec[i + nw:i + nw + nb]))
        i += nw + nb
    return out


def leaf_slices(like: Net) -> List[slice]:
    """The slice of each leaf in ``flat``'s order."""
    out, i = [], 0
    for w, b in like:
        for t in (w, b):
            out.append(slice(i, i + t.numel()))
            i += t.numel()
    return out
