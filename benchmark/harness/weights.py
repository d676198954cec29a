"""Parameters and noise drawn from a seed on the device.

``make_parameters`` draws every normal-initialised tensor of a spec
(``reference/*.parameter_spec``) from one ``torch.randn`` call on the
device and scales it in one multiply, so that both sides of a comparison
(the program's process and the reference's) hold the same tensors for the
same seed without any file between them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def make_parameters(spec: Sequence, seed: int, device,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = [(name, shape, init[1]) for name, shape, init in spec
              if init[0] == "normal"]
    sizes = [int(np.prod(shape)) for _, shape, _ in normal]
    total = sum(sizes)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    stds = torch.tensor([std for _, _, std in normal], device=device,
                        dtype=dtype)
    counts = torch.tensor(sizes, device=device)
    flat.mul_(torch.repeat_interleave(stds, counts, output_size=total))
    out = {name: part.view(shape) for (name, shape, _), part in
           zip(normal, flat.split(sizes))}
    for name, shape, init in spec:
        if init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
    for name, shape, init in spec:
        if init[0] == "copy":
            out[name] = out[init[1]].clone()
    return {name: out[name] for name, _, _ in spec}


def gumbel(shape, seed: int, device) -> torch.Tensor:
    """-log(-log(U)), U uniform in [tiny, 1), float32, drawn from ``seed``
    on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(shape, generator=gen, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))
