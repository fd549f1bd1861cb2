"""Trainer: checkpointed training loop, controllable over HAM (port of
``repro.train.loop``).

The loop itself is ordinary PyTorch; what HAM adds is the control plane:
``Trainer.register_handlers()`` exposes run/metrics/checkpoint/stop/step
as active messages under the reference's explicit names, so a host (or any
peer) drives a training worker exactly as HAM-Offload drives an
accelerator.  ``device=None`` trains on the card (raising where there is
none); ``init(seed)`` draws the params from the port's generator.
"""

from __future__ import annotations

import time

from repro_torch.ckpt.store import CheckpointStore
from repro_torch.core.registry import default_registry
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, as_tensors, batch_for_model
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.train.step import build_train_step


class Trainer:
    def __init__(
        self,
        cfg,
        opt_cfg: adamw.AdamWConfig | None = None,
        *,
        ckpt_dir: str | None = None,
        ckpt_every: int = 50,
        data_seed: int = 0,
        global_batch: int = 8,
        seq_len: int = 64,
        shard: int = 0,
        num_shards: int = 1,
        sharder=None,
        device=None,
    ):
        self.cfg = cfg
        self.model = build_model(cfg, device=device)
        self.device = self.model.device
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.sharder = sharder
        self.data = SyntheticTokens(
            DataConfig(cfg.vocab_size, seq_len, global_batch, seed=data_seed),
            shard=shard, num_shards=num_shards,
        )
        # the reference jits with donate_argnums=(0, 1); adamw.update writes
        # the params and moments in place instead
        self.step_fn = build_train_step(self.model, self.opt_cfg, sharder)
        self.store = CheckpointStore(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.params = None
        self.opt_state = None
        self.step = 0
        self.metrics_history: list[dict] = []
        self._stop_requested = False

    # -- lifecycle -------------------------------------------------------------

    def init(self, seed: int = 0) -> None:
        self.params = self.model.init(seed)
        self.opt_state = adamw.init(self.params)
        self.step = 0

    def maybe_restore(self) -> bool:
        """Restart path: resume from the latest checkpoint if one exists."""
        if self.store is None:
            return False
        latest = self.store.latest_step()
        if latest is None:
            return False
        if self.params is None:
            self.init()
        man = self.store.manifest(latest)
        reg = default_registry()
        if reg.initialised and "key_digest" in man:
            if man["key_digest"] != reg.table.digest.hex():
                raise RuntimeError(
                    "checkpoint written by a fleet with a different HAM "
                    "key map (same-source violation across restart)"
                )
        tree = self.store.restore(latest, {"params": self.params,
                                           "opt": self.opt_state})
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = latest
        return True

    def checkpoint(self, blocking: bool = False) -> None:
        if self.store is None:
            return
        reg = default_registry()
        meta = {"arch": self.cfg.name}
        if reg.initialised:
            meta["key_digest"] = reg.table.digest.hex()
        self.store.save(self.step, {"params": self.params, "opt": self.opt_state},
                        meta=meta, blocking=blocking)

    # -- stepping ---------------------------------------------------------------

    def run_steps(self, n: int) -> dict:
        if self.params is None:
            self.init()
        t0 = time.perf_counter()
        last = {}
        for _ in range(n):
            if self._stop_requested:
                break
            batch = as_tensors(batch_for_model(self.data, self.cfg, self.step), self.device)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch
            )
            self.step += 1
            last = {k: float(v) for k, v in metrics.items()}
            last["step"] = self.step
            self.metrics_history.append(last)
            if self.store is not None and self.step % self.ckpt_every == 0:
                self.checkpoint()
        last["wall_s"] = time.perf_counter() - t0
        return last

    def latest_metrics(self) -> dict:
        return self.metrics_history[-1] if self.metrics_history else {}

    # -- HAM control plane --------------------------------------------------------

    def register_handlers(self, registry=None, prefix: str = "train") -> None:
        """Expose the trainer as offloadable handlers (call before init())."""
        reg = registry or default_registry()
        reg.register(lambda n: self.run_steps(int(n)), name=f"{prefix}/run_steps")
        reg.register(lambda: self.latest_metrics(), name=f"{prefix}/metrics")
        reg.register(lambda: (self.checkpoint(blocking=True), self.step)[1],
                     name=f"{prefix}/checkpoint_now")
        reg.register(lambda: self.stop(), name=f"{prefix}/stop")
        reg.register(lambda: self.step, name=f"{prefix}/step")

    def stop(self) -> None:
        self._stop_requested = True
