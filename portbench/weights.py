"""Tables drawn on the device from a run's seed, as a configuration's
``init_method`` states.  A recommender module (``recommenders/<name>.py``)
draws its weights with these or with its own rule."""

from __future__ import annotations

import math

import torch


def draw_tables(conf: dict, shapes: dict, seed: int, device) -> dict:
    """The tables ``shapes`` {name: (rows, d)}, one width, drawn on
    ``device`` from ``seed`` in one call: ``normal`` stddev * N(0, 1);
    ``xavier`` uniform on +-sqrt(6 / (rows + d)) for each table."""
    names = list(shapes)
    rows = [shapes[n][0] for n in names]
    d = shapes[names[0]][1]
    gen = torch.Generator(device=device).manual_seed(seed)
    method = conf["init_method"]
    if method == "normal":
        flat = torch.randn(sum(rows), d, generator=gen, device=device)
        flat *= float(conf["stddev"])
    elif method == "xavier":
        flat = torch.rand(sum(rows), d, generator=gen, device=device)
        flat.mul_(2).sub_(1)
        for part, r in zip(flat.split(rows), rows):
            part *= math.sqrt(6.0 / (r + d))
    else:
        raise ValueError(f"no tables for init_method={method!r}")
    return dict(zip(names, flat.split(rows)))
