"""Host-side social preprocessing: SPu sets, the tie partition and CUNE's
latent friends (as ``cleverrec_tpu/data/social.py``).

- SPu (SBPR's social-positive item sets): the union of a user's friends'
  train items minus the user's own (utils/tools.py:116-127), with the
  per-item coefficient suk = how many of the user's friends consumed the
  item (utils/sampler.py:122-130), aligned with the sorted SPu lists.
- The tie partition (TBPR): strong and weak ties by the Jaccard overlap
  of the two users' friend neighbourhoods, split at a global quantile.
- CUNE (CUNE_BPR's latent friends, utils/tools.py:130-209): the
  co-consumption network, weighted greedy deep walks, skip-gram user
  embeddings, the top-K cosine neighbours, and SPu over those.

Everything but the skip-gram fit and the cosine top-K is numpy and scipy
and draws from one ``numpy.random.Generator`` in the JAX package's order,
so one seed gives the same walks.  The skip-gram fit is torch on the
trainer's device, its initial table drawn from a ``torch.Generator``
seeded from the same ``rng.integers(1 << 31)`` draw as the JAX key, and
its batches and negatives from ``rng`` as there.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import scipy.sparse as sp
import torch

from cleverrec_tpu_torch.common import make_optimizer


def flatten_friend_edges(user_friends: dict[int, list[int]]
                         ) -> tuple[np.ndarray, np.ndarray]:
    """{u: [v, ...]} -> flat (u, v) edge arrays (int32)."""
    sf_u = [u for u, friends in user_friends.items() for _ in friends]
    sf_v = [v for friends in user_friends.values() for v in friends]
    return np.asarray(sf_u, np.int32), np.asarray(sf_v, np.int32)


def build_spu(ui_train: dict[int, list[int]],
              user_friends: dict[int, list[int]]):
    """Returns (SPu, suk): {u: sorted social items}, {u: aligned counts}."""
    spu: dict[int, list[int]] = {}
    suk: dict[int, list[int]] = {}
    friend_sets = {f: set(items) for f, items in ui_train.items()}
    for u, items in ui_train.items():
        friends = user_friends.get(u)
        if not friends:
            continue
        own = set(items)
        cnt: Counter = Counter()
        seen_friend = set()
        for f in friends:
            if f in seen_friend or f not in friend_sets:
                continue
            seen_friend.add(f)
            for it in friend_sets[f]:
                if it not in own:
                    cnt[it] += 1
        if cnt:
            ks = sorted(cnt)
            spu[u] = ks
            suk[u] = [cnt[k] for k in ks]
    return spu, suk


def _cunet(ui_train: dict[int, list[int]], user_nums: int, item_nums: int):
    """Co-consumption weight matrix W = A A^T (diag zeroed), sparse CSR."""
    rows, cols = [], []
    for u, items in ui_train.items():
        for i in set(items):
            rows.append(u)
            cols.append(i)
    a = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=(user_nums, item_nums))
    w = (a @ a.T).tocsr()
    w.setdiag(0)
    w.eliminate_zeros()
    return w


def _deep_walks(w: sp.csr_matrix, walk_count: int, walk_length: int,
                rng: np.random.Generator) -> list[list[int]]:
    """Weighted greedy walks (utils/tools.py:144-170): step to the
    highest-weight neighbour not yet visited; when all are visited, to a
    weight-proportional random neighbour.  Walks come out shuffled."""
    walks = []
    for u in range(w.shape[0]):
        if w.indptr[u] == w.indptr[u + 1]:
            continue
        for _ in range(walk_count):
            path = [u]
            visited = {u}
            cur = u
            for _ in range(walk_length - 1):
                lo, hi = w.indptr[cur], w.indptr[cur + 1]
                if lo == hi:
                    break
                nbrs = w.indices[lo:hi]
                wts = w.data[lo:hi]
                fresh = ~np.isin(nbrs, list(visited), assume_unique=False)
                if fresh.any():
                    nxt = int(nbrs[fresh][np.argmax(wts[fresh])])
                else:
                    nxt = int(rng.choice(nbrs, p=wts / wts.sum()))
                path.append(nxt)
                visited.add(nxt)
                cur = nxt
            walks.append(path)
    order = rng.permutation(len(walks))
    return [walks[i] for i in order]


def _sgns_fit(walks: list[list[int]], n_nodes: int, dim: int, window: int,
              rng: np.random.Generator, epochs: int = 3, lr: float = 0.025,
              negatives: int = 5, device="cpu"):
    """Skip-gram with negative sampling over the walks (the word2vec
    objective, standing in for the reference's gensim call,
    utils/tools.py:173-177): Adam with optax's arithmetic over batches of
    8192 (center, context) pairs.  Returns (the input table [n_nodes,
    dim] f32 on ``device``, the per-step losses as a 1-D tensor)."""
    centers, contexts = [], []
    for path in walks:
        for i, c in enumerate(path):
            for j in range(max(0, i - window), min(len(path), i + window + 1)):
                if j != i:
                    centers.append(c)
                    contexts.append(path[j])
    if not centers:
        return torch.zeros((n_nodes, dim), device=device), torch.zeros(0)
    centers_t = torch.as_tensor(np.asarray(centers, np.int64), device=device)
    contexts_t = torch.as_tensor(np.asarray(contexts, np.int64),
                                 device=device)

    gen = torch.Generator().manual_seed(int(rng.integers(1 << 31)))
    params = {"in": (0.1 * torch.randn((n_nodes, dim), generator=gen)).to(
                  device).requires_grad_(),
              "out": torch.zeros((n_nodes, dim), device=device,
                                 requires_grad=True)}
    opt = make_optimizer("Adam", lr)
    state = opt.init(params)
    logsig = torch.nn.functional.logsigmoid
    losses = []
    batch, n = 8192, len(centers)
    for _ in range(epochs):
        order = rng.permutation(n)
        for s0 in range(0, n, batch):
            sel = order[s0: s0 + batch]
            if len(sel) < 16:
                continue
            neg = torch.as_tensor(rng.integers(0, n_nodes,
                                               (len(sel), negatives)),
                                  device=device)
            sel = torch.as_tensor(sel, device=device)
            ve = params["in"][centers_t[sel]]                 # [B, d]
            ue = params["out"][contexts_t[sel]]               # [B, d]
            ne = params["out"][neg]                           # [B, K, d]
            pos = logsig((ve * ue).sum(dim=1))
            negl = logsig(-torch.einsum("bd,bkd->bk", ve, ne)).sum(dim=1)
            loss = -(pos + negl).mean()
            grads = torch.autograd.grad(loss, list(params.values()))
            opt.update(params, dict(zip(params, grads)), state)
            losses.append(loss.detach())
    return params["in"].detach(), torch.stack(losses).cpu()


def _sgns_embeddings(walks: list[list[int]], n_nodes: int, dim: int,
                     window: int, rng: np.random.Generator,
                     device="cpu") -> np.ndarray:
    """The skip-gram user embeddings [n_nodes, dim] (float32 numpy)."""
    emb, _ = _sgns_fit(walks, n_nodes, dim, window, rng, device=device)
    return emb.cpu().numpy()


def build_cune_friends(ui_train: dict[int, list[int]], user_nums: int,
                       item_nums: int, walk_count: int, walk_length: int,
                       walk_dim: int, window_size: int, topk_f: int,
                       seed: int = 0, device="cpu"):
    """Top-K latent friends per user and the resulting (SPu, suk) sets
    (the CUNE pipeline, utils/tools.py:130-209): returns (friends, spu,
    suk).  The cosine top-K runs on ``device`` in blocks of 4096 rows
    (a dense [U, U] similarity would be quadratic in memory), each user
    excluded from its own list, friends by descending similarity."""
    rng = np.random.default_rng(seed)
    w = _cunet(ui_train, user_nums, item_nums)
    walks = _deep_walks(w, walk_count, walk_length, rng)
    emb = _sgns_embeddings(walks, user_nums, walk_dim, window_size, rng,
                           device=device)

    active = np.unique(np.concatenate([np.asarray(p) for p in walks])
                       if walks else np.zeros(0, np.int64))
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    unit = torch.as_tensor((emb / np.maximum(norms, 1e-12))[active],
                           device=device)
    n_act = len(active)
    k = min(topk_f, max(n_act - 1, 1))
    block = 4096
    top_rows = []
    for r0 in range(0, n_act, block):
        sims = unit[r0: r0 + block] @ unit.T
        rows = torch.arange(sims.shape[0], device=device)
        sims[rows, rows + r0] = -torch.inf                # self
        top_rows.append(torch.topk(sims, k, dim=1).indices.cpu().numpy())
    top = np.concatenate(top_rows) if top_rows else np.zeros((0, k), int)

    friends = {int(active[r]): [int(active[c]) for c in top[r]]
               for r in range(n_act)}
    spu, suk = build_spu(ui_train, friends)
    return friends, spu, suk


def build_tie_partitioned_spu(ui_train: dict[int, list[int]],
                              user_friends: dict[int, list[int]],
                              strong_ratio: float = 0.5):
    """TBPR's strong- and weak-tie item sets (CIKM'16, "Social
    recommendation with strong and weak ties").

    The strength of tie (u, v) is the Jaccard overlap of the two users'
    friend neighbourhoods, the endpoints themselves left out.  A global
    threshold at the (1 - strong_ratio) quantile of the positive
    strengths splits ties into strong and weak; a tie of zero overlap is
    weak.  Returns ({u: sorted strong-tie items}, {u: sorted weak-tie
    items}): each the union of that class's friends' train items minus
    the user's own, an item reachable through both classes counted
    strong."""
    friend_sets = {u: set(fs) for u, fs in user_friends.items()}
    item_sets = {u: set(it) for u, it in ui_train.items()}

    strengths = {}
    all_pos = []
    for u, fs in user_friends.items():
        nu = friend_sets.get(u, set())
        for v in fs:
            nv = friend_sets.get(v, set())
            nu_x = nu - {u, v}
            nv_x = nv - {u, v}
            union = len(nu_x | nv_x)
            t = (len(nu_x & nv_x) / union) if union else 0.0
            strengths[(u, v)] = t
            if t > 0:
                all_pos.append(t)
    thresh = (float(np.quantile(np.asarray(all_pos), 1.0 - strong_ratio))
              if all_pos else np.inf)

    strong_items: dict[int, list[int]] = {}
    weak_items: dict[int, list[int]] = {}
    for u, fs in user_friends.items():
        own = item_sets.get(u, set())
        s_set: set[int] = set()
        w_set: set[int] = set()
        for v in fs:
            items = item_sets.get(v)
            if not items:
                continue
            t = strengths[(u, v)]
            dst = s_set if (t > 0 and t >= thresh) else w_set
            dst |= (items - own)
        w_set -= s_set
        if s_set:
            strong_items[u] = sorted(s_set)
        if w_set:
            weak_items[u] = sorted(w_set)
    return strong_items, weak_items
