"""BPR and LightGCN as their papers and the configuration state them, with
Adam, in plain PyTorch.

- BPR (Rendle et al., UAI 2009): score(u, i) = <P[u], Q[i]>; a batch's
  loss is sum w * -log sigmoid(score(u, i) - score(u, j)) + reg * 0.5 *
  (|P[u] w|^2 + |Q[i] w|^2 + |Q[j] w|^2), rows scaled by their weight w
  (0 on padding slots).
- LightGCN (He et al., SIGIR 2020): E^(l+1) = D^-1/2 A D^-1/2 E^l over
  the bipartite train graph (both directions of every train pair, no
  self loops), the final tables the mean of layers 0..L; the same BPR
  loss on the final rows, the L2 term on the ego rows.
- Adam (Kingma and Ba; optax's scale_by_adam): b1 0.9, b2 0.999, eps
  1e-8, bias corrections at the incremented count, dense over every
  parameter.

``dtype`` is the precision the tables, moments and arithmetic are held
in: float32 as configured, bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8


class BPR:
    def __init__(self, weights: dict, reg: float, dtype=torch.float32):
        self.params = {k: weights[k].detach().to(dtype).clone()
                       .requires_grad_(True) for k in ("P", "Q")}
        self.reg = reg

    def tables(self):
        return self.params["P"], self.params["Q"]

    def loss(self, batch):
        p, q = self.tables()
        w = batch["w"].to(p.dtype)[:, None]
        ue, ie, je = p[batch["u"]] * w, q[batch["i"]] * w, q[batch["j"]] * w
        diff = (ue * ie).sum(1) - (ue * je).sum(1)
        l2 = (ue * ue).sum() + (ie * ie).sum() + (je * je).sum()
        return (-F.logsigmoid(diff) * w[:, 0]).sum() + self.reg * 0.5 * l2


def bipartite_graph(train_u, train_i, users: int, items: int, device):
    """(rows, cols, weights) of D^-1/2 A D^-1/2 over users + items nodes,
    items numbered after the users."""
    u = np.asarray(train_u, np.int64)
    i = np.asarray(train_i, np.int64) + users
    rows, cols = np.concatenate([u, i]), np.concatenate([i, u])
    deg = np.bincount(rows, minlength=users + items).astype(np.float64)
    w = 1.0 / np.sqrt(np.maximum(deg[rows] * deg[cols], 1.0))
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(cols, device=device),
            torch.as_tensor(w, dtype=torch.float32, device=device))


class LightGCN(BPR):
    def __init__(self, weights: dict, reg: float, graph, layers: int,
                 dtype=torch.float32):
        super().__init__(weights, reg, dtype)
        self.rows, self.cols, w = graph
        self.w = w.to(dtype)
        self.layers = layers

    def tables(self):
        p, q = self.params["P"], self.params["Q"]
        ego = torch.cat([p, q])
        total = ego
        for _ in range(self.layers):
            ego = torch.zeros_like(ego).index_add(
                0, self.rows, self.w[:, None] * ego[self.cols])
            total = total + ego
        final = total / (self.layers + 1)
        return final[:p.shape[0]], final[p.shape[0]:]

    def loss(self, batch):
        pf, qf = self.tables()
        p, q = self.params["P"], self.params["Q"]
        w = batch["w"].to(p.dtype)
        u, i, j = batch["u"], batch["i"], batch["j"]
        diff = (pf[u] * qf[i]).sum(1) - (pf[u] * qf[j]).sum(1)
        wc = w[:, None]
        l2 = ((p[u] * wc) ** 2).sum() + ((q[i] * wc) ** 2).sum() + (
            (q[j] * wc) ** 2).sum()
        return (-F.logsigmoid(diff) * w).sum() + self.reg * 0.5 * l2


def follow(model, batches, lr: float, fault: str | None = None) -> dict:
    """Adam steps of ``model`` over ``batches`` ({u, i, j, w} tensors):
    each step's loss, the first gradient's norm per leaf, and after all
    the steps each leaf's change and the norms of its two moments.
    ``fault``: ``unchanged`` (a step that leaves the state as it was) or
    ``half`` (the batch's second half left out, the loss over the rest
    scaled to the whole batch)."""
    params = model.params
    start = {k: p.detach().clone() for k, p in params.items()}
    mom = {k: (torch.zeros_like(p), torch.zeros_like(p))
           for k, p in params.items()}
    losses, first = [], None
    for t, batch in enumerate(batches, start=1):
        if fault == "half":
            keep = batch["u"].shape[0] // 2
            batch = {k: v[:keep] for k, v in batch.items()}
        loss = model.loss(batch) * (2 if fault == "half" else 1)
        grads = torch.autograd.grad(loss, list(params.values()))
        if first is None:
            first = {k: float(g.float().norm())
                     for k, g in zip(params, grads)}
        losses.append(float(loss.detach()))
        if fault == "unchanged":
            continue
        with torch.no_grad():
            bc1, bc2 = 1 - B1 ** t, 1 - B2 ** t
            for (k, p), g in zip(params.items(), grads):
                m, v = mom[k]
                m.mul_(B1).add_((1 - B1) * g)
                v.mul_(B2).add_((1 - B2) * g * g)
                p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS))
    change = {k: float((p.detach().float() - start[k].float()).norm())
              for k, p in params.items()}
    moments = {k: [float(m.float().norm()), float(v.float().norm())]
               for k, (m, v) in mom.items()}
    return {"loss": losses, "grad_norm": first, "change_norm": change,
            "moment_norms": moments}
