"""The traced slice of a run: ``torch.profiler`` over a fixed number of
decode blocks or train steps, started and stopped at their boundaries
after a ``synchronize``, with the program's counters read on both sides
and the benchmark's own spans (what each block and admission processed)
recorded in between.  ``record()`` gives the per-layer metrics' readers
what they read.

The slice records the device's activity alone: recording the host's
operators too slows a host-bound decode loop nearly twice over, and the
device's idle share would then describe the profiler.  Where the mix asks
for it (``profile.host_blocks``), a second slice right after the first
records both, and serves only to name the idle gaps by what the host was
doing (``breakdown``)."""

from __future__ import annotations

import time

from portbench import common, program


def prime(device) -> None:
    """Start and stop the profiler once on the calling (main) thread during
    set-up: the profiler's first start initialises its tracer, which has to
    happen on the thread that registered it, and takes a while."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        pass


def _activities(device, host: bool) -> list:
    from torch.profiler import ProfilerActivity

    if device.type != "cuda":
        return [ProfilerActivity.CPU]
    return [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])


class Slice:
    def __init__(self, device, sched=None, loops=()):
        self.device, self.sched, self.loops = device, sched, loops
        self.prof = self.host_prof = None
        self.host_done = True
        self.t0 = self.t1 = None
        self.before = self.after = None
        self.spans = {"decode_lengths": [], "prefill_lengths": [], "decode_tokens": 0,
                      "first_tokens": 0, "blocks": 0, "train_steps": 0}

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import profile

        self._sync()
        self.before = program.counters(self.sched, self.loops)
        self.prof = profile(activities=_activities(self.device, host=False))
        self.prof.start()
        self.t0 = time.monotonic()

    def stop(self):
        self._sync()
        t1 = time.monotonic()
        self.prof.stop()
        self.after = program.counters(self.sched, self.loops)
        # last: another thread takes the slice as done once ``t1`` is set
        self.t1 = t1

    @property
    def on(self) -> bool:
        return self.prof is not None and self.t1 is None

    @property
    def done(self) -> bool:
        return self.t1 is not None and self.host_done

    def start_host(self):
        """Start the second slice, which records the host's operators too."""
        from torch.profiler import profile

        self.host_done = False
        self.host_prof = profile(activities=_activities(self.device, host=True))
        self.host_prof.start()

    def stop_host(self):
        self._sync()
        self.host_prof.stop()
        self.host_done = True

    def record(self, conf: dict, mix: dict) -> dict:
        dev, _ = common.device_events(self.prof)
        gap_dev, host = dev, []
        if self.host_prof is not None:
            gap_dev, host = common.device_events(self.host_prof)
        return {"conf": conf, "mix": mix, "window_s": self.t1 - self.t0,
                "busy_s": common.busy_seconds(dev), "device_events": dev,
                "gap_device_events": gap_dev, "host_events": host,
                "counters": program.delta(self.after, self.before), "spans": self.spans}


class ServeSlice(Slice):
    """Wraps one engine replica's ``step_many`` and ``admit`` (they run on
    the worker's decode-loop thread): the profiler starts before the first
    block that begins at or after ``start_at`` and stops after ``blocks``
    blocks; the host's slice then runs on over the admissions that follow
    and the next ``host_blocks`` blocks."""

    def __init__(self, device, sched, replica, start_at: float, blocks: int, loops=(),
                 host_blocks: int = 0):
        super().__init__(device, sched, loops)
        self.rep, self.start_at, self.blocks = replica, start_at, blocks
        self.host_blocks, self.host_seen = host_blocks, 0
        self.host_done = host_blocks == 0
        self._step_many, self._admit = replica.step_many, replica.admit
        replica.step_many, replica.admit = self.step_many, self.admit

    def step_many(self, k):
        rep = self.rep
        if self.prof is None and time.monotonic() >= self.start_at:
            self.start()
        if self.on:
            # the cached length each active sequence's decode reads, per step
            per_step = [[] for _ in range(k)]
            for slot, req in enumerate(rep.slot_req):
                if req is None:
                    continue
                pos = len(req.prompt) + len(rep.outputs[req.rid]) - 1
                for i in range(min(k, int(rep.slot_remaining[slot]))):
                    per_step[i].append(pos + i + 1)
            self.spans["decode_lengths"].extend(s for s in per_step if s)
        out = self._step_many(k)
        if self.on and out:
            self.spans["decode_tokens"] += len(out)
            self.spans["blocks"] += 1
            if self.spans["blocks"] >= self.blocks:
                self.stop()
                if not self.host_done:
                    self.start_host()   # the admissions that follow, and the next blocks
        elif self.host_prof is not None and not self.host_done and out:
            self.host_seen += 1
            if self.host_seen >= self.host_blocks:
                self.stop_host()
        return out

    def admit(self, req, slot):
        out = self._admit(req, slot)
        if self.on:
            self.spans["prefill_lengths"].append(len(req.prompt))
            self.spans["first_tokens"] += 1
        return out

    def restore(self):
        """Put the replica's methods back and let go of it."""
        self.rep.step_many, self.rep.admit = self._step_many, self._admit
        self.rep = self._step_many = self._admit = None
