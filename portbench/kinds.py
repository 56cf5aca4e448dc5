"""The kinds of timed unit a traffic mix can drive: a training epoch
(``train``), an evaluation (``eval``) and a retrieval call (``serve``).

Each kind builds the port's objects from a configuration, draws the
weights from the run's seed on the device, runs one unit at a time for
the window, hands over what the port produced, and judges it against
the reference once the port is freed.  What a kind needs to know of the
configuration's model (its parameters, their draw, its reference) comes
from ``recommenders/<recommender>.py``; a kind names no model.
``reference_outputs`` puts the reference in the port's place (the
control, in the precision below the configured one, or a planted fault)
for the check's own calibration and tests.
"""

from __future__ import annotations

import gc
import json
import math
import os
import time

import numpy as np
import torch

from portbench import compare, synth
from portbench.reference import models as ref_models
from portbench.reference import ranking as ref_ranking
from portbench.reference.split import split as ref_split

ADAM_B1 = 0.9          # the configuration's Adam (optax's defaults)
SPAN = "portbench."    # host spans the trace keeps
SPIN_S = 0.02          # a serve caller waits this close to a call's due
#                        time by spinning, not sleeping


def recommender(conf: dict):
    """``recommenders/<recommender>.py`` of the configuration's model."""
    from portbench import harness
    return harness.module("recommenders", conf["conf"]["recommender"])


def draw_batches(draw: dict, steps: int, device) -> list[dict]:
    """The first ``steps`` steps of a sampler draw as reference batches."""
    return [{k: torch.as_tensor(draw[k][s], device=device,
                                dtype=torch.float32 if k == "w"
                                else torch.int64)
             for k in ("u", "i", "j", "w")} for s in range(steps)]


class Kind:
    """What every kind shares: the configuration as the port reads it, its
    data and model, the benchmark's weights and the reference's split."""

    def __init__(self, conf: dict, mix: dict, device, data_dir: str):
        self.conf, self.mix = conf, mix
        self.device = torch.device(device)
        self.data_dir = data_dir
        self.params = conf["conf"]
        self.rec = recommender(conf)
        self.seed = None
        self._split = None
        self.spans: dict = {}

    # -- the port ---------------------------------------------------------
    def port_config(self):
        from cleverrec_tpu_torch.config import Config
        return Config({**self.params,
                       "data.root_dir": os.path.dirname(self.data_dir),
                       "data.dataset": os.path.basename(self.data_dir),
                       "data.file_name": synth.CSV_NAME, "data.sep": ","})

    def port_model(self):
        """(config, data, model) of the port; the model's own draw of its
        weights is replaced by the benchmark's (``fill``)."""
        from cleverrec_tpu_torch.data import load_ranking_data
        from cleverrec_tpu_torch.models import make_model
        from cleverrec_tpu_torch.models.base import DataMeta
        cfg = self.port_config()
        data = load_ranking_data(cfg)
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                           device=self.device)
        model.init = lambda generator: None
        return cfg, data, model

    def weights(self, users: int, items: int) -> dict:
        return self.rec.weights(self.params, users, items, self.seed,
                                self.device)

    def fill(self, model) -> None:
        own = dict(model.named_parameters())
        want = self.rec.tables(self.params, model.meta.user_nums,
                               model.meta.item_nums)
        if {k: tuple(p.shape) for k, p in own.items()} != want:
            raise ValueError(f"{model.name}'s parameters are not {want}")
        w = self.weights(model.meta.user_nums, model.meta.item_nums)
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(w[k])

    # -- the reference ----------------------------------------------------
    def split(self):
        if self._split is None:
            self._split = ref_split(synth.load_raw(self.data_dir),
                                    self.params)
        return self._split

    def ref_model(self, dtype=torch.float32):
        sp = self.split()
        return self.rec.reference(self.weights(sp.users, sp.items),
                                  self.params, sp, self.device, dtype)

    def ref_tables(self):
        """The reference's final user and item tables, in FP32."""
        with torch.no_grad():
            return tuple(t.detach() for t in self.ref_model().tables())

    def shape(self) -> dict:
        """The run's sizes for the configuration's work-count functions."""
        sp = self.split()
        b, neg = int(self.params["batch_size"]), int(self.params["neg_ratio"])
        users, indptr, ids = sp.tests()
        seen_ptr, _ = sp.seen()
        n_train = len(sp.train_u)
        return {"users": sp.users, "items": sp.items,
                "d": int(self.params["embed_size"]),
                "layers": int(self.params.get("n_layers", 0)),
                "batch": b, "neg_ratio": neg, "train_pairs": n_train,
                "steps": -(-n_train * neg // b), "edges": 2 * n_train,
                "test_users": len(users), "test_ids": len(ids),
                "test_seen_ids": int((seen_ptr[users + 1]
                                      - seen_ptr[users]).sum()),
                "test_batch": int(self.params["test.batch_size"]),
                "seen_per_user": n_train / sp.users,
                "call_users": int(self.mix.get("users_per_call", 0)),
                "k": int(self.mix.get("k", 0))}

    def span(self, name: str, fn):
        """fn() inside a host span ``name``, the device synchronised on
        both sides; its seconds go to ``spans``."""
        sync(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN + name):
            out = fn()
        sync(self.device)
        self.spans[name] = time.perf_counter() - t0
        return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Train(Kind):
    """``Trainer.train_epoch`` back to back from a warmed state.  Set-up
    trains the first ``check_steps`` steps of the first epoch's draw
    through ``train_epoch`` itself, the window's own call, in two calls:
    the first step alone (the first gradient, read from Adam's first
    moment), then the rest in one call, whose one launch of the epoch's
    kernel runs step after step as the window's launches do.  It keeps
    each call's loss, the parameters' change and Adam's moments after the
    steps, which the reference follows afterwards."""

    FAULTS = ("unchanged", "half")

    def build(self):
        from cleverrec_tpu_torch.train import Trainer
        cfg, data, model = self.port_model()
        self.trainer = Trainer(model, data, cfg, device=self.device)

    def reseed(self, seed: int):
        self.seed = seed
        t = self.trainer
        self.state = t.init_state(seed)
        self.fill(t.model)

    def prepare(self, warm: bool = True):
        self.outputs = {"readings": self._first_steps(), "draw": self.draw}
        for _ in range(int(self.mix["warm_units"]) if warm else 0):
            self.unit()

    def calls(self) -> list[tuple[int, int]]:
        """The check's ``train_epoch`` calls, as [lo, hi) steps."""
        n = int(self.mix["check_steps"])
        if n < 3:
            raise ValueError("check_steps: the second call needs two steps")
        return [(0, 1), (1, n)]

    def _first_steps(self) -> dict:
        t = self.trainer
        params, opt = self.state
        draw = t.sample_epoch()
        self.draw = {k: v.cpu().numpy() for k, v in draw.items()}
        pad = draw["w"] == 0
        start = {k: p.detach().clone() for k, p in params.items()}
        losses, first = [], None
        for lo, hi in self.calls():
            part = {k: v[lo:hi] for k, v in draw.items()}
            t.sample_epoch = lambda part=part: part
            try:
                params, opt, loss = t.train_epoch(params, opt)
            finally:
                del t.sample_epoch
            if t.fused:
                # The fused tier takes the whole epoch's padding slots'
                # loss off a draw's mean loss; this draw holds some steps'.
                loss += (float(pad.sum() - pad[lo:hi].sum())
                         * self.rec.PAD_SLOT_LOSS / (hi - lo))
            losses.append(loss)
            if first is None:
                first = {k: float(opt.mu[k].norm()) / (1 - ADAM_B1)
                         for k in params}
        change = {k: float((p.detach() - start[k]).norm())
                  for k, p in params.items()}
        moments = {k: [float(opt.mu[k].norm()), float(opt.nu[k].norm())]
                   for k in params}
        self.state = (params, opt)
        return {"loss": losses, "grad_norm": first, "change_norm": change,
                "moment_norms": moments}

    def unit(self, traced: bool = False):
        t = self.trainer
        self.spans = {}
        if traced:
            t.sample_epoch = lambda: self.span(
                "sample", lambda: type(t).sample_epoch(t))
        try:
            params, opt, loss = t.train_epoch(*self.state)
        finally:
            if traced:
                del t.sample_epoch
        if not math.isfinite(loss):
            raise RuntimeError(f"epoch loss {loss}")
        self.state = (params, opt)
        return {"epochs": 1}

    def collect(self) -> dict:
        return self.outputs

    def free(self):
        del self.trainer, self.state
        release(self.device)

    def _follow(self, outputs, control: bool = False,
                fault: str | None = None) -> dict:
        """The reference's readings over the check's steps, each call's
        loss the mean of its steps' (``follow``), in the configured
        precision or in the recommender's ``CONTROL``."""
        batches = draw_batches(outputs["draw"], int(self.mix["check_steps"]),
                               self.device)
        tf32 = control and self.rec.CONTROL == "tf32"
        dtype = (getattr(torch, self.rec.CONTROL) if control and not tf32
                 else torch.float32)
        with ref_ranking.precision(tf32):
            out = ref_models.follow(self.ref_model(dtype), batches,
                                    float(self.params["lr"]), fault)
        out["loss"] = [float(np.mean(out["loss"][lo:hi]))
                       for lo, hi in self.calls()]
        return out

    def reference_outputs(self, how: str) -> dict:
        """The readings with the reference in the port's place: ``control``
        in the recommender's ``CONTROL`` precision, or the fault ``how``
        (``unchanged``, ``half``) in float32."""
        readings = (self._follow(self.outputs, control=True)
                    if how == "control"
                    else self._follow(self.outputs, fault=how))
        return {"readings": readings, "draw": self.outputs["draw"]}

    def check(self, outputs: dict) -> dict:
        sp = self.split()
        out = compare.train_numbers(outputs["readings"],
                                    self._follow(outputs))
        out.update(compare.draw_numbers(outputs["draw"], sp.train_u,
                                        sp.train_i, sp.items,
                                        int(self.params["neg_ratio"]),
                                        sp.seen(), self.device))
        return out


class Eval(Kind):
    """``Trainer.evaluate`` back to back on the weights drawn from the
    seed: every test user ranked over the catalog, metrics reduced on the
    device.  Afterwards the port's top-k of every test user
    (``Evaluator.recommend_topk``, the same batches and rankers) and the
    last evaluation's metrics are judged."""

    FAULTS = ("half", "altered")

    def build(self):
        from cleverrec_tpu_torch.train import Trainer
        cfg, data, model = self.port_model()
        self.trainer = Trainer(model, data, cfg, device=self.device)
        self.kmax = max(json.loads(self.params["topk"]))

    def reseed(self, seed: int):
        self.seed = seed
        self.trainer.init_state(seed)
        self.fill(self.trainer.model)

    def prepare(self, warm: bool = True):
        # One evaluation at least: its metrics are what the check judges.
        for _ in range(int(self.mix["warm_units"]) if warm else 1):
            self.unit()

    def unit(self, traced: bool = False):
        self.spans = {}
        self.last = self.trainer.evaluate()
        return {"evaluations": 1}

    def collect(self) -> dict:
        t = self.trainer
        ids = t.evaluator.recommend_topk(t.aux)[:, :self.kmax]
        return {"ids": np.asarray(ids, np.int64),
                "users": np.asarray(t.dd.test_users, np.int64),
                "metrics": self.last}

    def free(self):
        del self.trainer
        release(self.device)

    def reference_outputs(self, how: str) -> dict:
        """The reference in the port's place: ``control`` ranks with TF32
        on; ``half`` takes the metrics' mean over the first half of the
        test users alone; ``altered`` replaces each user's first answer
        with a random item."""
        sp = self.split()
        users, indptr, ids = sp.tests()
        pf, qf = self.ref_tables()
        rec = ref_ranking.topk_ids(pf, qf, users, sp.seen(), self.kmax,
                                   tf32=how == "control")
        if how == "altered":
            rng = np.random.default_rng(self.seed)
            rec[:, 0] = rng.integers(0, sp.items, len(rec))
        part = slice(0, len(users) // 2 if how == "half" else len(users))
        sums = ref_ranking.metric_sums(rec[part], users[part], (indptr, ids),
                                       json.loads(self.params["topk"]))
        n = len(users[part])
        return {"ids": rec, "users": users,
                "metrics": {k: tuple(v / n) for k, v in sums.items()}}

    def check(self, outputs: dict) -> dict:
        sp = self.split()
        users, indptr, ids = sp.tests()
        pf, qf = self.ref_tables()
        got_users = outputs["users"]
        out = {"test_users": float(len(np.setxor1d(users, got_users)))}
        out.update(compare.rank_numbers(outputs["ids"], got_users, pf, qf,
                                        sp.seen()))
        rec = ref_ranking.topk_ids(pf, qf, users, sp.seen(), self.kmax)
        sums = ref_ranking.metric_sums(rec, users, (indptr, ids),
                                       json.loads(self.params["topk"]))
        out.update(compare.metric_numbers(outputs["metrics"], sums,
                                          len(users)))
        return out


class Serve(Kind):
    """``build_retrieval_fn`` under load from one caller: each call asks
    for the top ``k`` unseen items of ``users_per_call`` distinct users,
    drawn in set-up from the seed in proportion to each user's
    interactions.  With ``calls_per_s`` the load is offered at that rate,
    one call every 1 / ``calls_per_s`` seconds from the window's start (an
    open loop): a call that is due waits for the one before it, and its
    latency runs from when it was due until its ids are on the host.
    Without it the loop is closed: each call is issued as soon as the
    last one's ids are on the host, and its latency is its own.  A sample
    of ``check_calls`` calls, drawn from the seed, is judged afterwards."""

    FAULTS = ("half", "altered")

    def build(self):
        from cleverrec_tpu_torch.data import build_device_data
        _, data, self.model = self.port_model()
        self.dd = build_device_data(data)

    def reseed(self, seed: int):
        from cleverrec_tpu_torch.serving import build_retrieval_fn
        self.seed = seed
        self.fill(self.model)
        self.retrieve = build_retrieval_fn(
            self.model, None, self.dd, k=int(self.mix["k"]),
            filter_seen=True, backend=self.mix["backend"],
            device=self.device)
        self.pool = self.calls(seed)
        self.n_calls, self.due = 0, None
        self.kept: list = []
        self.keep_rng = np.random.default_rng(seed)

    def calls(self, seed: int) -> list[np.ndarray]:
        """``pool_calls`` calls' users: distinct users a call, drawn with
        probability in proportion to each user's interactions."""
        raw = synth.load_raw(self.data_dir)
        weight = np.bincount(np.searchsorted(np.unique(raw["u"]),
                                             raw["u"])).astype(np.float64)
        rng = np.random.default_rng(seed)
        b = int(self.mix["users_per_call"])
        return [rng.choice(len(weight), b, replace=False,
                           p=weight / weight.sum()).astype(np.int64)
                for _ in range(int(self.mix["pool_calls"]))]

    def prepare(self, warm: bool = True):
        for _ in range(int(self.mix["warm_units"]) if warm else 0):
            self.unit()
        self.n_calls, self.kept, self.due = 0, [], None

    def unit(self, traced: bool = False):
        self.spans = {}
        users = self.pool[self.n_calls % len(self.pool)]
        rate = self.mix.get("calls_per_s")
        now = time.perf_counter()
        if self.due is None or rate is None:
            self.due = now
        while now < self.due:
            # Spin while the call is near: a sleep can wake a millisecond
            # late, and the caller's lateness would read as latency.
            if self.due - now > SPIN_S:
                time.sleep(self.due - now - SPIN_S)
            now = time.perf_counter()
        items, scores = self.retrieve(users)
        ids = items.cpu().numpy()
        got = scores.cpu().numpy()
        done = time.perf_counter()
        latency, service = done - self.due, done - now
        if rate is not None:
            self.due += 1.0 / float(rate)
        # Reservoir sampling: every call alike likely to be judged.
        keep = int(self.mix["check_calls"])
        self.n_calls += 1
        if len(self.kept) < keep:
            self.kept.append((users, ids, got))
        else:
            at = int(self.keep_rng.integers(0, self.n_calls))
            if at < keep:
                self.kept[at] = (users, ids, got)
        return {"users": len(users), "latency_s": latency,
                "service_s": service}

    def collect(self) -> dict:
        return {"calls": list(self.kept)}

    def free(self):
        del self.retrieve, self.model, self.dd
        release(self.device)

    def reference_outputs(self, how: str) -> dict:
        """The reference in the port's place on the judged calls' users:
        ``control`` scores with TF32 on; ``half`` answers each call's
        second half of users with the first half's answers; ``altered``
        replaces each user's first answer with a random item."""
        sp = self.split()
        k = int(self.mix["k"])
        pf, qf = self.ref_tables()
        rng = np.random.default_rng(self.seed)
        out = []
        for users, _, _ in self.kept:
            rows = pf[torch.as_tensor(users, device=self.device)]
            s = ref_ranking.masked_scores(rows, qf, ref_ranking.seen_mask(
                users, *sp.seen(), sp.items, self.device),
                tf32=how == "control")
            top = torch.topk(s, k, dim=1)
            ids, got = top.indices.cpu().numpy(), top.values.cpu().numpy()
            if how == "half":
                h = len(users) // 2
                ids[h:2 * h], got[h:2 * h] = ids[:h], got[:h]
            elif how == "altered":
                ids[:, 0] = rng.integers(0, sp.items, len(ids))
            out.append((users, ids, got))
        return {"calls": out}

    def check(self, outputs: dict) -> dict:
        sp = self.split()
        pf, qf = self.ref_tables()
        calls = outputs["calls"]
        return compare.rank_numbers(
            np.concatenate([c[1] for c in calls]),
            np.concatenate([c[0] for c in calls]), pf, qf, sp.seen(),
            np.concatenate([c[2] for c in calls]))


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


KINDS = {"train": Train, "eval": Eval, "serve": Serve}
