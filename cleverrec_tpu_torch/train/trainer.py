"""The training loop: the main-path parts of
``cleverrec_tpu/train/trainer.py``.

An epoch is the model's sampler's whole epoch as [steps, B] tensors,
drawn in one pass from an explicit generator on the trainer's device:
(u, i, j, w) for the pairwise protocol (BPR, LRML, TransCF), (u, i, y,
w) for the pointwise one (GMF, MLP, NeuMF), (u, i, w) and negs
[steps, B, neg_ratio] for ``cml`` (CML), (u, i, k, j, suk, w) for
``sbpr`` (SBPR, CUNE_BPR) and (u, i, s, t, j, w) for ``tbpr`` (TBPR).
The model's ``build_aux`` runs first (the social models' SPu lists and
exclusion tables, TransCF's inverse degrees) and its ``epoch_pairs``
give the pairs the epoch covers.  ``Trainer.aux``, which the loss and
the evaluator read, holds those pairs as ``pos_u`` and ``pos_i`` and
the numeric arrays of ``build_aux`` as device tensors (as the JAX
trainer's ``arrays``); the sampler's tables stay out of it.  It is
trained through one of two tiers:

- the fused tier (Adam and ``train.fused_kernel`` on; it defaults on for
  a CUDA device and off on the CPU), one call of an ``ops.train`` epoch
  function, the CUDA kernel on the card and its plain version on the
  CPU, chosen by the model's ``fused_protocol``:
  ``pairwise_bpr`` (the bpr loss only) runs ``fused_bpr_epoch`` and
  ``pointwise_bce`` runs ``fused_gmf_epoch``, both with invalid slots at
  the sentinel ids and ``n_sent * LOG2`` taken off the loss;
  ``cml_hinge`` (the hinge loss only) runs ``fused_cml_epoch``, invalid
  slots at the sentinel ids in u, i and every negative plane, and
  ``n_sent * cml_sentinel_bias`` taken off the loss;
  ``pointwise_mlp`` runs ``fused_mlp_epoch`` over the model's
  ``fused_mlp_spec``, masked by w in the kernel, with no correction;
  ``rows`` runs ``fused_rows_epoch`` over the model's
  ``fused_rows_spec`` (the social BPR chain, or LRML's form), invalid
  slots at the sentinel ids, masked in the kernel, with no correction
  (``train.fused_stream`` selects the same kernel: on the card the state
  stays in device memory either way);
- the scan tier: per step, autograd of ``model.loss``, the optax-semantics
  update of ``common.make_optimizer``, then ``model.postprocess``.

Parameters live in the model (``params`` is ``dict(model.named_parameters())``)
and are updated in place, so the evaluator always scores the current
tables.  Loss accounting matches the reference: per-batch summed loss
averaged over the number of batches (RankingRecommender.py:61).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from cleverrec_tpu_torch import sampling
from cleverrec_tpu_torch.common import cdiv, make_optimizer, resolve_device
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data.arrays import DeviceData, build_device_data
from cleverrec_tpu_torch.data.dataset import RankingData
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models.base import RecModel
from cleverrec_tpu_torch.ops.train import (LOG2, cml_sentinel_bias,
                                           fused_bpr_epoch, fused_cml_epoch,
                                           fused_gmf_epoch, fused_mlp_epoch,
                                           fused_rows_epoch, mlp_epoch_plan,
                                           rows_epoch_plan, sentinel_dims)

# Options of the JAX trainer that the port does not have yet, each with
# the test that it is set and where ROADMAP.md queues it.  A set option
# raises rather than be ignored.
_TIERS = "queue 1, item 17 (the trainer's VMEM-capacity tiers)"
_UNPORTED = (
    ("train.fused_bf16", lambda c, k: c.bool(k), _TIERS),
    ("train.fused_grouped", lambda c, k: c.bool(k), _TIERS),
    ("train.fused_groups", lambda c, k: c.int(k, 0) > 1, _TIERS),
    ("train.sparse_rows_force", lambda c, k: c.bool(k),
     "queue 1, item 9 (the lazy row-Adam tier)"),
    ("train.sbpr_epoch_tensors", lambda c, k: not c.bool(k, True),
     "queue 1, item 9 (the per-step social samplers)"),
    ("save.best", lambda c, k: c.bool(k), "queue 1, item 15 (checkpoints)"),
    ("gmf_pretrain", lambda c, k: k in c, "queue 1, item 15 (warm starts)"),
    ("mlp_pretrain", lambda c, k: k in c, "queue 1, item 15 (warm starts)"),
    ("fism_pretrain", lambda c, k: k in c, "queue 1, item 15 (warm starts)"),
    ("profile.dir", lambda c, k: bool(c.get(k)),
     "queue 1, item 4 (the port's benchmark and traces)"),
)


def _refuse_unported(cfg: Config) -> None:
    for key, is_set, where in _UNPORTED:
        if is_set(cfg, key):
            raise NotImplementedError(
                f"{key} is not ported yet (ROADMAP.md {where})")
    if cfg.str("neg_sampling", "uniform") != "uniform":
        raise NotImplementedError(
            "only uniform negatives are ported; neg_sampling="
            f"{cfg.str('neg_sampling')} waits (ROADMAP.md queue 1, item 7)")


def _joined(tensors, names):
    """The named [N, w_k] tensors side by side, [N, sum w_k]; a single
    one is the tensor itself."""
    if len(names) == 1:
        return tensors[names[0]].detach()
    return torch.cat([tensors[n].detach() for n in names], dim=1)


def _split_back(tensors, names, joined):
    """Copy each slice of ``joined`` back into the tensor it came from."""
    if len(names) == 1:
        return
    off = 0
    for n in names:
        width = tensors[n].shape[1]
        tensors[n].detach().copy_(joined[:, off:off + width])
        off += width


class Trainer:
    """Trains ``model`` on ``data`` on ``device`` (default ``cuda``; the
    model is moved there) and evaluates it with the ``Evaluator``."""

    def __init__(self, model: RecModel, data: RankingData, cfg: Config,
                 logger=None, device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP.md queue 1, item 16)")
        _refuse_unported(cfg)
        if model.sampler not in ("pairwise", "pointwise", "cml", "sbpr",
                                 "tbpr"):
            raise NotImplementedError(
                f"sampler {model.sampler!r} is not ported yet: the port "
                "trains the pairwise, pointwise, cml, sbpr and tbpr "
                "protocols (ROADMAP.md queue 1)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.logger = logger
        self.dd: DeviceData = build_device_data(data)
        # build_aux may restrict the epoch's pairs (the social family), so
        # it runs before epoch_pairs.
        self.model_aux = model.build_aux(self.dd, data)
        pos_u, pos_i = model.epoch_pairs(self.dd)
        self.n_pairs = len(pos_u)
        self.batch_size = cfg.batch_size
        self.neg_ratio = cfg.neg_ratio
        # A pointwise pair is one positive row and neg_ratio negatives; a
        # CML pair is one row that carries its neg_ratio negatives.
        self._epoch_rows = self.n_pairs * {
            "pointwise": self.neg_ratio + 1, "cml": 1}.get(model.sampler,
                                                          self.neg_ratio)
        self.steps_per_epoch = cdiv(self._epoch_rows, self.batch_size)
        padded = self.steps_per_epoch * self.batch_size
        self._n_sent = padded - self._epoch_rows
        self._build_layout(pos_u, pos_i, padded)
        self.aux: dict[str, torch.Tensor] = {
            name: torch.as_tensor(a, device=self.device)
            for name, a in (("pos_u", pos_u), ("pos_i", pos_i),
                            *self.model_aux.items())
            if isinstance(a, np.ndarray)}
        self.optimizer = make_optimizer(cfg.optimizer, cfg.lr)
        self.fused = self._fused_epoch_eligible()
        self._gen: torch.Generator | None = None
        self.evaluator = Evaluator(model, self.dd, cfg, device=self.device)

    def _build_layout(self, pos_u, pos_i, padded: int) -> None:
        """The sampler's per-run constants on the device: the static epoch
        layout, the membership table its negatives avoid (the seen items,
        or the social models' seen-union-social table), and the social
        models' CSR lists."""
        aux, dd, sampler = self.model_aux, self.dd, self.model.sampler
        neg = aux.get("social_neg", dd.seen)
        head = (pos_u, pos_i, neg.lens)
        tail = (dd.item_nums, padded, self.neg_ratio)
        if sampler == "sbpr":
            spu = aux["spu_csr"]
            static = sampling.sbpr_epoch_static(
                *head, sampling.csr_lens(spu), spu["off"], *tail)
        elif sampler == "tbpr":
            ts, tw = aux["ts_csr"], aux["tw_csr"]
            static = sampling.tbpr_epoch_static(
                *head, sampling.csr_lens(ts), ts["off"], sampling.csr_lens(tw),
                tw["off"], *tail)
        elif sampler == "pointwise":
            static = sampling.pointwise_epoch_static(*head, *tail)
        elif sampler == "cml":
            # One row per pair, its negatives drawn per row: the pairwise
            # layout at neg_ratio 1.
            static = sampling.pairwise_epoch_static(*head, *tail[:2], 1)
        else:
            static = sampling.pairwise_epoch_static(*head, *tail)

        def put(a):
            return torch.as_tensor(a, device=self.device)

        self._static = {k: put(v) for k, v in static.items()}
        self._neg_rows, self._neg_lens = put(neg.rows), put(neg.lens)
        self._csr = {name: {k: put(c[k]) for k in ("flat", "suk")}
                     for name, c in aux.items() if name.endswith("_csr")}

    def _fused_epoch_eligible(self) -> bool:
        """The fused epoch kernels hard-code their model's form and Adam;
        the BPR kernel also the -log sigmoid objective (GMF's sigmoid
        cross-entropy is its only objective, as in the JAX trainer), and
        the CML kernel the hinge.
        ``train.fused_kernel`` turns the tier on or off (default: on for
        a CUDA device).  A tower the kernel does not take (more than 4
        layers, or shared memory short) or a rows spec outside the forms
        the kernel has a backward for (the social BPR chain, LRML's hinge)
        is declined here, with a log line, and trains through the scan
        tier."""
        proto = getattr(self.model, "fused_protocol", None)
        if (proto is None or self.cfg.optimizer != "Adam"
                or (proto == "pairwise_bpr" and self.cfg.loss_func != "bpr")
                or (proto == "cml_hinge" and self.cfg.loss_func != "hinge")
                or not self.cfg.bool("train.fused_kernel",
                                     self.device.type == "cuda")):
            return False
        try:
            if proto == "pointwise_mlp":
                spec = self.model.fused_mlp_spec()
                n_layers = (len(spec["dense"]) - 1) // 2
                mlp_epoch_plan(spec["gmf_width"],
                               [tuple(getattr(self.model, n).shape)
                                for n in spec["dense"][:n_layers]])
            elif proto == "rows":
                rows_epoch_plan(self.model.fused_rows_spec())
        except ValueError as e:
            if self.logger:
                self.logger.info("fused epoch kernel skipped (%s); using the "
                                 "scan tier", e)
            return False
        if (proto == "rows" and self.logger
                and self.cfg.bool("train.fused_stream", False)):
            self.logger.info("train.fused_stream: the streamed rows epoch is "
                             "the same kernel here (the state stays in "
                             "device memory)")
        return True

    # -- one epoch ------------------------------------------------------
    def sample_epoch(self) -> dict[str, torch.Tensor]:
        """The next epoch's draw of the model's sampler, each column
        [steps, B] on the device."""
        if self._gen is None:
            raise RuntimeError("call init_state first")
        head = (self._gen, self._static, self._neg_rows, self._neg_lens)
        lists = {"sbpr": ("spu_csr",), "tbpr": ("ts_csr", "tw_csr")}.get(
            self.model.sampler, ())
        tensors_fn = {"sbpr": sampling.sbpr_epoch_tensors,
                      "tbpr": sampling.tbpr_epoch_tensors,
                      "pointwise": sampling.pointwise_epoch_tensors,
                      "pairwise": sampling.pairwise_epoch_tensors,
                      "cml": functools.partial(sampling.cml_epoch_tensors,
                                               neg_ratio=self.neg_ratio)}[
                          self.model.sampler]
        return tensors_fn(*head, *(self._csr[n] for n in lists),
                          self._epoch_rows, self.steps_per_epoch,
                          self.batch_size)

    def _run_epoch(self, params, opt_state, tensors):
        """Train one epoch on given sampled tensors ([steps, B] each);
        returns (params, opt_state, mean per-step loss as a 0-dim tensor).
        ``params`` must be the model's own parameters."""
        if self.fused:
            return self._fused_epoch(params, opt_state, tensors)
        return self._scan_epoch(params, opt_state, tensors)

    def _scan_epoch(self, params, opt_state, tensors):
        names = list(params)
        leaves = [params[k] for k in names]
        steps = tensors["u"].shape[0]
        losses = torch.zeros(steps, dtype=torch.float32, device=self.device)
        for s in range(steps):
            batch = {k: v[s] for k, v in tensors.items()}
            loss = self.model.loss(batch, self.aux)
            # A parameter outside the loss (NeuMF's h_gmf and h_mlp, kept
            # for the warm start) gets a zero gradient, as under JAX:
            # Adam then leaves it and its moments as they were.
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, torch.autograd.grad(
                         loss, leaves, allow_unused=True))]
            opt_state = self.optimizer.update(params, dict(zip(names, grads)),
                                              opt_state)
            self.model.postprocess()
            losses[s] = loss.detach()
        return params, opt_state, losses.mean()

    def _fused_epoch(self, params, opt_state, tensors):
        u_sent, i_sent = (n - 1 for n in sentinel_dims(self.dd.user_nums,
                                                       self.dd.item_nums))
        inval = tensors["w"] == 0

        def ids(name, sentinel):
            return torch.where(inval, sentinel, tensors[name]).to(
                torch.int32).contiguous()

        def col(name):
            return tensors[name].to(torch.float32).contiguous()

        steps = tensors["u"].shape[0]
        proto, t0, lr = self.model.fused_protocol, opt_state.count, self.cfg.lr

        def with_moments(name):
            return (params[name].detach(), opt_state.mu[name],
                    opt_state.nu[name])

        if proto == "pairwise_bpr":
            (p, mp, vp), (q, mq, vq) = map(with_moments, ("P", "Q"))
            raw = fused_bpr_epoch(p, q, mp, vp, mq, vq, ids("u", u_sent),
                                  ids("i", i_sent), ids("j", i_sent), t0,
                                  lr=lr, reg=self.model.reg)
            loss = raw - self._n_sent * LOG2
        elif proto == "pointwise_bce":
            (p, mp, vp), (q, mq, vq), (h, mh, vh) = map(
                with_moments, ("P", "Q", "h_gmf"))
            raw = fused_gmf_epoch(p, q, h, mp, vp, mq, vq, mh, vh,
                                  ids("u", u_sent), ids("i", i_sent),
                                  col("y"), t0, lr=lr, reg=self.model.reg)
            loss = raw - self._n_sent * LOG2
        elif proto == "cml_hinge":
            (p, mp, vp), (q, mq, vq) = map(with_moments, ("P", "Q"))
            negs = torch.where(inval[..., None], i_sent, tensors["negs"]).to(
                torch.int32).contiguous()
            margin, item_nums = self.model.margin, self.dd.item_nums
            raw = fused_cml_epoch(p, q, mp, vp, mq, vq, ids("u", u_sent),
                                  ids("i", i_sent), negs, t0, lr=lr,
                                  reg=self.model.reg, margin=margin,
                                  item_nums=item_nums)
            loss = raw - self._n_sent * cml_sentinel_bias(
                margin, item_nums, self.neg_ratio)
        elif proto == "rows":
            spec = self.model.fused_rows_spec()
            sides = [sd for _, sd in spec["planes"]]
            planes = [ids(name, u_sent if sd == "u" else i_sent)
                      for name, sd in spec["planes"]]
            state = [x for t in (params, opt_state.mu, opt_state.nu)
                     for x in spec["pack"](t)]
            loss = fused_rows_epoch(*state, planes,
                                    [col(n) for n in spec["floats"]], t0,
                                    sides=sides, spec=spec, lr=lr)
        else:
            loss = self._fused_mlp(params, opt_state, ids("u", u_sent),
                                   ids("i", i_sent), col("y"), col("w"))
        # Adam's count advances by the padded step count, as in the JAX
        # trainer: padded steps are Adam steps too.
        opt_state.count += steps
        return params, opt_state, loss / steps

    def _fused_mlp(self, params, opt_state, u, i, y, w):
        """The tower epoch over the model's spec: each side's tables joined
        on the feature axis (NeuMF: [P_gmf | P_mlp]) for the epoch, then
        split back; the dense params are updated where they are.  Params
        outside the spec pass through unchanged."""
        spec = self.model.fused_mlp_spec()
        state = []
        for t in (params, opt_state.mu, opt_state.nu):
            state += [_joined(t, spec["u"]), _joined(t, spec["i"]),
                      [t[n].detach() for n in spec["dense"]]]
        raw = fused_mlp_epoch(*state, u, i, y, w, opt_state.count, spec=spec,
                              lr=self.cfg.lr)
        for k, t in enumerate((params, opt_state.mu, opt_state.nu)):
            _split_back(t, spec["u"], state[3 * k])
            _split_back(t, spec["i"], state[3 * k + 1])
        return raw

    # -- public API -----------------------------------------------------
    def init_state(self, seed: int | None = None):
        """(params, opt_state) of a fresh run: the model's parameters drawn
        from a generator seeded with ``seed`` (default ``cfg.seed``), and
        the sampler's device generator seeded from the same stream."""
        gen = torch.Generator().manual_seed(
            self.cfg.seed if seed is None else seed)
        self.model.init(gen)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=gen)))
        params = dict(self.model.named_parameters())
        return params, self.optimizer.init(params)

    def train_epoch(self, params, opt_state):
        params, opt_state, loss = self._run_epoch(params, opt_state,
                                                  self.sample_epoch())
        return params, opt_state, float(loss)

    def train_epochs(self, params, opt_state, n_epochs: int):
        """n epochs in a row; returns (params, opt_state, losses[n])."""
        losses = []
        for _ in range(n_epochs):
            params, opt_state, loss = self.train_epoch(params, opt_state)
            losses.append(loss)
        return params, opt_state, losses

    def evaluate(self) -> dict[int, tuple[float, float, float]]:
        """{K: (HR, MRR, NDCG)} of the model's current parameters."""
        return self.evaluator.evaluate(self.aux)

    def run(self, seed: int | None = None, resume_from: str | None = None):
        """Full train/eval loop with best-NDCG@topk[0] tracking
        (RankingRecommender.py:400-440).  Each epoch line carries its
        numbers as the log record's ``train`` attribute, each eval's as
        ``eval``, and the summary's as ``best``."""
        if resume_from:
            raise NotImplementedError(
                "resuming is not ported yet (ROADMAP.md queue 1, item 15)")

        def log(msg, *args, **extra):
            if self.logger:
                self.logger.info(msg, *args, extra=extra)

        params, opt_state = self.init_state(seed)
        topk = self.cfg.topk
        best = {"epoch": 0, "ndcg": 0.0, "metrics": {}}
        interval = self.cfg.test_interval
        epoch = 0
        while epoch < self.cfg.epoches:
            next_eval = min(((epoch // interval) + 1) * interval,
                            self.cfg.epoches)
            block = next_eval - epoch
            t1 = time.perf_counter()
            params, opt_state, losses = self.train_epochs(params, opt_state,
                                                          block)
            train_s = time.perf_counter() - t1
            epoch = next_eval
            log(" epoch %d\n  Training loss: %.4f, time: %.2fs (%d epochs)",
                epoch, losses[-1], train_s, block,
                train={"epoch": epoch, "losses": losses, "seconds": train_s})
            if epoch % interval:
                continue
            t2 = time.perf_counter()
            results = self.evaluate()
            eval_s = time.perf_counter() - t2
            log("  Testing time: %.2fs", eval_s,
                eval={"epoch": epoch, "seconds": eval_s, "metrics": results})
            for k in topk:
                hr, mrr, ndcg = results[k]
                log("  (k=%d) HR=%.4f, MRR=%.4f, NDCG=%.4f", k, hr, mrr, ndcg)
            if results[topk[0]][2] > best["ndcg"]:
                best = {"epoch": epoch, "ndcg": results[topk[0]][2],
                        "metrics": results}
        log("best_epoch: %d", best["epoch"], best=best)
        for k in topk:
            if k in best["metrics"]:
                hr, mrr, ndcg = best["metrics"][k]
                log("  (k=%d) HR=%.4f, MRR=%.4f, NDCG=%.4f", k, hr, mrr, ndcg)
        return best
