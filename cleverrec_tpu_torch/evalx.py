"""Evaluation engine: candidate-list and full-catalog top-K ranking
(as ``cleverrec_tpu/evalx.py``).

- ``candidate`` (loo or neg_samples>0): score each test user's candidate
  list (negatives first, ground truth last), rank it, map ranks back to
  item ids; metrics against candidates[neg_samples:],
- full catalog: score all items with the user's seen TRAIN items masked,
  then top-k; ``full_fused`` runs the masked-scoring CUDA kernels for
  models with a ``dot_decomposition`` (default on a CUDA device,
  ``eval.fused_kernel`` forces either way), ``full`` plain PyTorch, and
  ``full_stream`` ranks item chunks with a carried running top-k
  (``ranking.rank_stream``): by default past ``STREAM_THRESHOLD`` items
  (``eval.stream_threshold``) unless ``eval.fused_kernel`` is set,
  always with ``eval.stream=true``, never with ``eval.stream=false``;
  chunks of ``eval.stream_chunk`` items (16384 past 262,144 items, else
  4096); ``full_sharded``, under a mesh (``parallel/mesh.py``), ranks
  each model rank's slice of the item axis and merges the ranks' top-k
  over the mesh's ``model`` axis (``ranking.rank_sharded``): any mesh,
  a ``1 x 1`` one too, sends full-catalog evaluation there, never to the
  fused kernels or the stream, as the JAX evaluator does.

Under a model axis whose tables are row-sharded (``model.row_shards``)
each evaluation reads them through the exchange's views
(``sharding.table_views``, ``serve``), set up once an evaluation: a
candidate list's rows come through the row-sharded gather, a
dot-decomposable model scores its own item rows, and any other model's
full-table reads see tables all-gathered once an evaluation.

The test set is stacked once into padded user batches on the device; a
Python loop ranks each batch and reduces it to per-K metric sums (the
reference's HR/MRR/NDCG formulas, utils/metrics.py:9-19), so the host
receives one [n_K, 3] array per eval.  Past the global bitmap budget
(``seen.bits`` None) the bitmap-masking modes build bitmaps from the
sorted seen rows: ``full_fused`` builds the test users' once per
Evaluator while they fit ``eval.test_bitmap_budget_mb`` (default 512
MiB), else each batch's, and ``full_stream`` each batch's;
``eval.device_bitmaps=false`` turns that off (``full_fused`` then falls
back to ``full``, the stream masks with the rows), as in the JAX
evaluator.
"""

from __future__ import annotations

import numpy as np
import torch

from cleverrec_tpu_torch import ranking
from cleverrec_tpu_torch.common import cdiv, resolve_device
from cleverrec_tpu_torch.data.arrays import DeviceData
from cleverrec_tpu_torch.metrics import PAD_ITEM, ranking_metrics_topks
from cleverrec_tpu_torch.ops.topk import topk
from cleverrec_tpu_torch.parallel.sharding import table_views
from cleverrec_tpu_torch.sampling import rows_to_bits
from cleverrec_tpu_torch.utils import trace


def _pad_masked(v, items):
    return torch.where(torch.isfinite(v), items, torch.full_like(items,
                                                                 PAD_ITEM))


# A full-catalog eval streams past this many items unless
# eval.fused_kernel is set (cleverrec_tpu/evalx.py:76-79).
STREAM_THRESHOLD = 500_000


class Evaluator:
    """Evaluates ``model`` on ``device`` (default ``cuda``; the model is
    moved there), over ``mesh``'s model axis if given."""

    def __init__(self, model, device_data: DeviceData, cfg, device="cuda",
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = model.to(self.device)
        self.dd = device_data
        self.cfg = cfg
        self.topk = cfg.topk
        self.kmax = max(self.topk)
        self.batch_size_t = cfg.test_batch_size
        self.candidate_eval = device_data.cand is not None
        self.standard_mrr = cfg.bool("metrics.standard_mrr", False)
        # Bitmap masking: from the global table where it exists, else
        # built from the sorted rows unless eval.device_bitmaps is off.
        bitmaps = (device_data.seen.bits is not None
                   or cfg.bool("eval.device_bitmaps", True))
        fused_ok = (not self.candidate_eval and bitmaps and mesh is None
                    and hasattr(model, "dot_decomposition"))
        self._use_fused = fused_ok and cfg.bool(
            "eval.fused_kernel", self.device.type == "cuda")
        # An explicit eval.fused_kernel=true beats the streaming default;
        # an explicit eval.stream wins over everything.
        fused_forced = self._use_fused and "eval.fused_kernel" in cfg
        items = device_data.item_nums
        stream = not self.candidate_eval and mesh is None and cfg.bool(
            "eval.stream", items > cfg.int("eval.stream_threshold",
                                           STREAM_THRESHOLD)
            and not fused_forced)
        # Wider chunks amortise the per-chunk merge at large catalogs.
        self.stream_chunk = cfg.int("eval.stream_chunk",
                                    16384 if items > 262_144 else 4096)
        # Chunk-sliced bitmap masking needs 32 | chunk: from the global
        # bitmaps where they exist, else from each batch's rows
        # (sampling.rows_to_bits); otherwise rank_stream masks with rows.
        self._stream_bits = self.stream_chunk % 32 == 0 and bitmaps
        if self.candidate_eval:
            self.mode = "candidate"
        elif mesh is not None:
            self.mode = "full_sharded"
        elif stream:
            self.mode = "full_stream"
        elif self._use_fused:
            self.mode = "full_fused"
        else:
            self.mode = "full"
        self._batches = self._build_batches()

    # -- rankers: [b, kmax] item ids, PAD_ITEM where masked -------------
    def _rank_candidates(self, aux, u, cand, mask):
        scores = self.model.score_candidates(u, cand, aux)
        if self.model.cml_like:
            scores = -scores          # ascending distance, descending score
        scores = scores.masked_fill(~mask, -torch.inf)
        v, idx = topk(scores, min(self.kmax, cand.shape[1]))
        return _pad_masked(v, torch.gather(cand, 1, idx))

    def _rank_full(self, aux, u, seen_rows):
        return _pad_masked(*ranking.rank_dense(self.model, aux, u, seen_rows,
                                               self.kmax))

    def _rank_full_sharded(self, aux, u, seen_rows):
        return _pad_masked(*ranking.rank_sharded(
            self.model, aux, u, seen_rows, self.kmax, self.mesh))

    def _rank_full_fused(self, aux, u, seen_bits=None, seen_rows=None,
                         pre=None):
        # Past the global bitmap budget the batches carry rows; build the
        # batch's bitmaps from them.
        if seen_bits is None:
            seen_bits = rows_to_bits(seen_rows, self.dd.item_nums)
        return _pad_masked(*ranking.rank_fused(
            self.model, aux, u, seen_bits, self.kmax, pre=pre))

    def _rank_full_stream(self, aux, u, seen_bits=None, seen_rows=None):
        if seen_bits is None and self._stream_bits:
            seen_bits = rows_to_bits(seen_rows, self.dd.item_nums)
            seen_rows = None
        return _pad_masked(*ranking.rank_stream(
            self.model, aux, u, seen_rows, self.dd.item_nums, self.kmax,
            chunk=self.stream_chunk, seen_bits=seen_bits))

    def _rank_batch(self, aux, b, pre):
        if self.candidate_eval:
            return self._rank_candidates(aux, b["u"], b["cand"], b["mask"])
        if self.mode == "full_fused":
            return self._rank_full_fused(aux, b["u"], b.get("bits"),
                                         b.get("rows"), pre=pre)
        if self.mode == "full_stream":
            return self._rank_full_stream(aux, b["u"], b.get("bits"),
                                          b.get("rows"))
        if self.mode == "full_sharded":
            return self._rank_full_sharded(aux, b["u"], b["rows"])
        return self._rank_full(aux, b["u"], b["rows"])

    # -- batches ------------------------------------------------------------
    def _build_batches(self):
        """The whole test set as [n_batches, bt, ...] device tensors
        (built once; row_w zeroes the wrapped pad rows)."""
        dd = self.dd
        t = len(dd.test_users)
        bt = self.batch_size_t
        nb = cdiv(t, bt)
        padded = nb * bt
        order = np.arange(padded) % t                     # pad wraps around
        users = dd.test_users[order].astype(np.int64)

        def put(a):
            a = np.asarray(a)
            return torch.as_tensor(a.reshape(nb, bt, *a.shape[1:]),
                                   device=self.device)

        out = {"u": put(users),
               "row_w": put((np.arange(padded) < t).astype(np.float32)),
               "real": put(dd.real_padded[order])}
        if self.candidate_eval:
            out["cand"] = put(dd.cand[order].astype(np.int64))
            out["mask"] = put(dd.cand_mask[order])
        elif dd.seen.bits is not None and (
                self.mode == "full_fused" or (self.mode == "full_stream"
                                              and self._stream_bits)):
            out["bits"] = put(dd.seen.bits[users])
        else:
            out["rows"] = put(dd.seen.rows[users].astype(np.int64))
            words = cdiv(dd.item_nums, 32)
            budget = self.cfg.int("eval.test_bitmap_budget_mb", 512)
            if (self.mode == "full_fused"
                    and padded * words * 4 <= budget * 2 ** 20):
                # The test users' bitmaps do not change with training:
                # built once here, a batch at a time, rather than each
                # batch at every eval.
                out["bits"] = torch.stack([
                    rows_to_bits(r, dd.item_nums) for r in out.pop("rows")])
        return out

    def _batch(self, idx):
        return {k: v[idx] for k, v in self._batches.items()}

    def _aux(self, aux):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in (aux or {}).items()}

    # -- metrics --------------------------------------------------------------
    def _metric_sums(self, rec, real, row_w):
        """Per-K (HR, MRR, NDCG) sums over a batch — the torch form of
        metrics.ranking_metrics (reference utils/metrics.py:9-19)."""
        valid = real != PAD_ITEM                          # [b, T]
        n_real = valid.sum(dim=1)
        n_real_safe = n_real.clamp(min=1)
        matches = ((real[:, :, None] == rec[:, None, :])
                   & valid[:, :, None]
                   & (rec != PAD_ITEM)[:, None, :])       # [b, T, kmax]
        found = matches.any(dim=2)
        # argmax of a bool row: the first match (the first True).
        rank = torch.where(found, matches.to(torch.uint8).argmax(dim=2),
                           self.kmax)
        slot = torch.arange(real.shape[1], dtype=torch.float32,
                            device=real.device)
        idcg = torch.where(valid, 1.0 / torch.log2(slot + 2.0),
                           0.0).sum(dim=1).clamp(min=1e-12)
        w = row_w * (n_real > 0)
        per_k = []
        for k in self.topk:
            hit_k = found & (rank < k)
            hits = hit_k.sum(dim=1).float()
            hr = hits / n_real_safe.clamp(max=k)
            if self.standard_mrr:
                best = torch.where(hit_k, rank, self.kmax).amin(dim=1)
                mrr = torch.where(best < k, 1.0 / (best + 1.0), 0.0)
            else:
                mrr = torch.where(hit_k, 1.0 / (rank + 1.0), 0.0).sum(dim=1)
            dcg = torch.where(hit_k, 1.0 / torch.log2(rank + 2.0),
                              0.0).sum(dim=1)
            ndcg = dcg / idcg
            per_k.append(torch.stack([(hr * w).sum(), (mrr * w).sum(),
                                      (ndcg * w).sum()]))
        return torch.stack(per_k)                         # [n_K, 3]

    def _pre(self, aux):
        return (ranking.fused_precompute(self.model, aux)
                if self.mode == "full_fused" else None)

    # -- host driver ------------------------------------------------------
    @torch.no_grad()
    def recommend_topk(self, aux=None) -> np.ndarray:
        """Top-K item lists for all test users, in test-user order."""
        aux = self._aux(aux)
        pre = self._pre(aux)
        with table_views(self.model, self.mesh, "serve"):
            outs = [self._rank_batch(aux, self._batch(i), pre).cpu().numpy()
                    for i in range(self._batches["u"].shape[0])]
        return np.concatenate(outs, axis=0)[:len(self.dd.test_users)]

    def evaluate_host(self, aux=None):
        """Host-metrics path (numpy formulas) — the cross-check oracle for
        the on-device reduction; also used when eval.host_metrics is set."""
        rec_all = self.recommend_topk(aux)
        per_k = ranking_metrics_topks(self.dd.real_padded, rec_all,
                                      self.topk,
                                      standard_mrr=self.standard_mrr)
        return {k: (float(hr.mean()), float(mrr.mean()), float(ndcg.mean()))
                for k, (hr, mrr, ndcg) in per_k.items()}

    @torch.no_grad()
    def evaluate(self, aux=None) -> dict[int, tuple[float, float, float]]:
        """Returns {K: (mean HR, mean MRR, mean NDCG)} over all test users.
        Inside the span ``eval.evaluate``: each batch in ``eval.batch``,
        its metric sums in ``eval.metrics``."""
        with trace.span("eval.evaluate"):
            if self.cfg.bool("eval.host_metrics", False):
                return self.evaluate_host(aux)
            aux = self._aux(aux)
            pre = self._pre(aux)
            sums = torch.zeros((len(self.topk), 3), device=self.device)
            with table_views(self.model, self.mesh, "serve"):
                for i in range(self._batches["u"].shape[0]):
                    with trace.span("eval.batch"):
                        b = self._batch(i)
                        rec = self._rank_batch(aux, b, pre)
                        with trace.span("eval.metrics"):
                            sums += self._metric_sums(rec, b["real"],
                                                      b["row_w"])
            sums = sums.cpu().numpy()
        t = len(self.dd.test_users)
        return {k: tuple(float(x) / t for x in sums[idx])
                for idx, k in enumerate(self.topk)}
