"""The training loop: the main-path parts of
``cleverrec_tpu/train/trainer.py``.

An epoch is the pairwise sampler's whole (u, i, j, w) [steps, B], drawn
in one pass from an explicit generator on the trainer's device, then
trained through one of two tiers:

- the fused tier (``fused_protocol == "pairwise_bpr"``, Adam, the bpr
  loss, ``train.fused_kernel`` on; it defaults on for a CUDA device and
  off on the CPU): invalid slots go to the sentinel ids and one call of
  ``ops.train.fused_bpr_epoch`` trains the epoch, the CUDA kernel on the
  card and its plain version on the CPU;
- the scan tier: per step, autograd of ``model.loss``, the optax-semantics
  update of ``common.make_optimizer``, then ``model.postprocess``.

Parameters live in the model (``params`` is ``dict(model.named_parameters())``)
and are updated in place, so the evaluator always scores the current
tables.  Loss accounting matches the reference: per-batch summed loss
averaged over the number of batches (RankingRecommender.py:61).
"""

from __future__ import annotations

import time

import torch

from cleverrec_tpu_torch import sampling
from cleverrec_tpu_torch.common import cdiv, make_optimizer, resolve_device
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data.arrays import DeviceData, build_device_data
from cleverrec_tpu_torch.data.dataset import RankingData
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models.base import RecModel
from cleverrec_tpu_torch.ops.train import LOG2, fused_bpr_epoch, sentinel_dims

# Options of the JAX trainer that the port does not have yet, each with
# the test that it is set and where ROADMAP.md queues it.  A set option
# raises rather than be ignored.
_TIERS = "queue 1, item 17 (the trainer's VMEM-capacity tiers)"
_UNPORTED = (
    ("train.fused_bf16", lambda c, k: c.bool(k), _TIERS),
    ("train.fused_grouped", lambda c, k: c.bool(k), _TIERS),
    ("train.fused_stream", lambda c, k: c.bool(k), _TIERS),
    ("train.fused_groups", lambda c, k: c.int(k, 0) > 1, _TIERS),
    ("train.sparse_rows_force", lambda c, k: c.bool(k),
     "queue 1, item 9 (the lazy row-Adam tier)"),
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


class Trainer:
    """Trains ``model`` on ``data`` on ``device`` (default ``cuda``; the
    model is moved there) and evaluates it with the ``Evaluator``."""

    def __init__(self, model: RecModel, data: RankingData, cfg: Config,
                 logger=None, device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP.md queue 1, item 16)")
        _refuse_unported(cfg)
        if model.sampler != "pairwise":
            raise NotImplementedError(
                f"sampler {model.sampler!r} is not ported yet: the port "
                "trains the pairwise protocol (ROADMAP.md queue 1)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.logger = logger
        self.dd: DeviceData = build_device_data(data)
        self.n_pairs = self.dd.num_pairs
        self.batch_size = cfg.batch_size
        self.neg_ratio = cfg.neg_ratio
        self._epoch_rows = self.n_pairs * self.neg_ratio
        self.steps_per_epoch = cdiv(self._epoch_rows, self.batch_size)
        padded = self.steps_per_epoch * self.batch_size
        self._n_sent = padded - self._epoch_rows

        def put(a):
            return torch.as_tensor(a, device=self.device)

        self._static = {k: put(v) for k, v in sampling.pairwise_epoch_static(
            self.dd.pos_u, self.dd.pos_i, self.dd.seen.lens,
            self.dd.item_nums, padded, self.neg_ratio).items()}
        self._seen_rows = put(self.dd.seen.rows)
        self._seen_lens = put(self.dd.seen.lens)
        self.aux: dict[str, torch.Tensor] = {}
        self.optimizer = make_optimizer(cfg.optimizer, cfg.lr)
        self.fused = self._fused_epoch_eligible()
        self._gen: torch.Generator | None = None
        self.evaluator = Evaluator(model, self.dd, cfg, device=self.device)

    def _fused_epoch_eligible(self) -> bool:
        """The fused epoch kernel hard-codes BPR's {P, Q} dot-product
        form, the -log sigmoid objective and Adam; ``train.fused_kernel``
        turns it on or off (default: on for a CUDA device)."""
        return (getattr(self.model, "fused_protocol", None) == "pairwise_bpr"
                and self.cfg.optimizer == "Adam"
                and self.cfg.loss_func == "bpr"
                and self.cfg.bool("train.fused_kernel",
                                  self.device.type == "cuda"))

    # -- one epoch ------------------------------------------------------
    def sample_epoch(self) -> dict[str, torch.Tensor]:
        """The next epoch's (u, i, j, w), each [steps, B] on the device."""
        if self._gen is None:
            raise RuntimeError("call init_state first")
        return sampling.pairwise_epoch_tensors(
            self._gen, self._static, self._seen_rows, self._seen_lens,
            self._epoch_rows, self.steps_per_epoch, self.batch_size)

    def _run_epoch(self, params, opt_state, tensors):
        """Train one epoch on given sampled tensors (u, i, j, w [steps, B]);
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
            grads = torch.autograd.grad(loss, leaves)
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

        steps = tensors["u"].shape[0]
        state = (params["P"].detach(), params["Q"].detach(),
                 opt_state.mu["P"], opt_state.nu["P"],
                 opt_state.mu["Q"], opt_state.nu["Q"])
        raw = fused_bpr_epoch(*state, ids("u", u_sent), ids("i", i_sent),
                              ids("j", i_sent), opt_state.count,
                              lr=self.cfg.lr, reg=self.model.reg)
        # Adam's count advances by the padded step count, as in the JAX
        # trainer: padded steps are Adam steps too.
        opt_state.count += steps
        return params, opt_state, (raw - self._n_sent * LOG2) / steps

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
        return self.evaluator.evaluate()

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
