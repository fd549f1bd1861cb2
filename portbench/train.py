"""The training driver: one cell of a ``"kind": "train"`` mix through the
program's ``Trainer``, driven over HAM as its users drive it: the
``train/run_steps`` handler called through a local ``OffloadDomain``.

Set-up builds the one trainer object (the model, the weights made from the
seed, AdamW's state) and runs its first ``check_steps`` steps through the
window's own call and feed; they warm every shape up and give the readings
that decide ``correct``: each step's loss, the first gradient as AdamW got
it (its first moment after one step over 1 - b1), the parameters' change
after the last of them (the leaf minus the leaf as made, made again one
layer at a time), and of a mixture of experts the experts each token was
routed to in each step's forward pass (``adapter.RouteRecorder``).  The
window then runs the same trainer on, a step a call, and ends on a
``synchronize`` after the first step that ends at or after ``seconds``:

* ``train_tokens_per_s``: batch x seq_len x the steps of the window, over
  the window.

``correct``: once the program's state is freed, the plain float32
reference trains the same weights on the same rows for the same steps (a
mixture of experts on the experts the program chose, each choice judged
against the reference's own router: ``route_gap``), and the numbers that
the cell's limits file names are compared with their limits (see
:func:`readings`).
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time

from portbench import common, traffic


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _walk(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def run(ctx) -> dict:
    import torch

    dev = torch.device(ctx.device)
    # the program's part returns plain numbers only: once it has returned,
    # none of its tensors is held, and the reference has the card
    out, prog, record, peak, n, finite = _program(ctx, dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, ctx.conf, ctx.seed, dev, ctx.mix, prog)
    return {"metrics": out, "attempted": n, "failed": 0 if finite else n,
            "memory_peak_bytes": peak, "checks": checks, "record": record}


def _program(ctx, dev):
    import torch

    from repro_torch.core.closure import f2f
    from repro_torch.core.registry import HandlerRegistry
    from repro_torch.offload.api import OffloadDomain
    from repro_torch.offload.runtime import register_internal_handlers
    from repro_torch.optim import adamw
    from repro_torch.train.loop import Trainer

    from portbench import adapter, program, trace

    conf, mix, seed, seconds = ctx.conf, ctx.mix, ctx.seed, ctx.seconds
    opt = mix["optimizer"]
    plain = common.reference(conf)
    paths = plain.leaf_paths(conf)
    trainer = Trainer(program.model_config(conf), adamw.AdamWConfig(**opt),
                      global_batch=mix["batch"], seq_len=mix["seq_len"], device=dev)
    trainer.data = traffic.TrainBatches(mix, conf["vocab_size"], seed)
    trainer.params = plain.make_weights(conf, seed, dev, getattr(torch, conf["param_dtype"]))
    trainer.opt_state = adamw.init(trainer.params)
    trainer.step = 0
    reg = HandlerRegistry()
    register_internal_handlers(reg)
    trainer.register_handlers(reg)
    reg.init()
    dom = OffloadDomain.local(2, registry=reg)
    out, record = {}, None
    try:
        def steps(n):
            return dom.sync(1, f2f("train/run_steps", n, registry=reg), timeout=600)

        moe = "num_experts" in conf
        routes, route_calls = [], []
        with adapter.RouteRecorder() if moe else contextlib.nullcontext() as rec:
            for s in range(mix["check_steps"]):
                steps(1)
                if moe:
                    calls = rec.take()
                    route_calls.append(len(calls))
                    routes.append(forward_routes(calls, conf["num_hidden_layers"]))
                if s == 0:
                    with torch.no_grad():
                        grad_norms = [float(_walk(trainer.opt_state["mu"], p).double().norm())
                                      / (1 - opt["b1"]) for p in paths]
                        # the first gradient itself, to the host, where a limit asks for it
                        first = ([(_walk(trainer.opt_state["mu"], p) / (1 - opt["b1"])).cpu()
                                  for p in paths]
                                 if ctx.control or any(k.startswith("grad_diff")
                                                       for k in ctx.limits)
                                 else None)
        losses = [h["loss"] for h in trainer.metrics_history]
        change_norms = [plain.change_norm(conf, seed, p, _walk(trainer.params, p))
                        for p in paths]
        if ctx.trace:
            trace.prime(dev)
        _sync(dev)
        out["setup_s"] = time.monotonic() - ctx.t_start

        tracer = trace.Slice(dev) if ctx.trace else None
        prof = mix["profile"]
        t0 = time.monotonic()
        n = 0
        while n == 0 or time.monotonic() - t0 < seconds:
            if tracer is not None and n == prof["after_steps"]:
                tracer.start()
            steps(1)
            n += 1
            if tracer is not None and tracer.on and n == prof["after_steps"] + prof["steps"]:
                tracer.stop()
                tracer.spans["train_steps"] = prof["steps"]
        _sync(dev)
        window = time.monotonic() - t0
        out["train_tokens_per_s"] = mix["batch"] * mix["seq_len"] * n / window
        finite = all(math.isfinite(h["loss"]) for h in trainer.metrics_history)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if tracer is not None and tracer.done:
            record = tracer.record(conf, mix)
            record["spans"].update(batch=mix["batch"], seq=mix["seq_len"])
        out["window"] = {"steps": n, "seconds": window,
                         "last_loss": trainer.metrics_history[-1]["loss"]}
    finally:
        dom.shutdown()
        trainer.params = trainer.opt_state = trainer.model = trainer.step_fn = None
    prog = {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
    if first is not None:
        prog["first_grads"] = first
    if moe:
        prog["routes"] = routes
        ctx.extra["route_calls"] = route_calls
    return out, prog, record, peak, n, finite


def forward_routes(calls: list, layers: int) -> list:
    """One step's routing, a (G, Tg, k) tensor per layer, from the calls the
    recorder saw in it: the forward pass's ``layers`` come first (a
    recomputing backward routes each layer again, after them)."""
    if len(calls) < layers:
        raise RuntimeError(f"saw {len(calls)} calls of the program's routing in a step of "
                           f"{layers} layers: repro_torch.models.moe._route_groups no longer "
                           f"routes (portbench/adapter.py)")
    return calls[:layers]


def readings(prog: dict, ref: dict, paths, device, relative_diffs) -> dict:
    """The numbers compared, of a run ``prog`` against ``ref``: the largest
    relative gap of a step's loss; for the first gradient and for the
    change the worst leaf's gap of norms (``*_gap``) and the median leaf's
    (``*_gap_median``), each over the reference's norm of that leaf or of
    the median leaf, whichever is larger; where both kept the first
    gradient itself, its relative difference ||g - g_ref|| / ||g_ref|| at
    the median leaf, the least and the worst (``grad_diff_median``,
    ``grad_diff_least``, ``grad_diff``); and where ``ref`` followed the
    run's routing, the widest gap of a chosen expert's router logit below
    the k-th best in the reference (``route_gap``)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref)
    grad = [abs(a - b) / max(b, g_med) for a, b in zip(prog["grad_norms"], g_ref)]
    keep = [i for i, b in enumerate(g_ref) if b >= 1e-3 * g_med]
    c_med = statistics.median(ref["change_norms"][i] for i in keep)
    change = {i: abs(prog["change_norms"][i] - ref["change_norms"][i])
              / max(ref["change_norms"][i], c_med) for i in keep}
    out = {"loss_gap": loss, "grad_gap": max(grad), "change_gap": max(change.values()),
           "grad_gap_median": statistics.median(grad),
           "change_gap_median": statistics.median(change.values()),
           "leaves_left_out": len(g_ref) - len(keep)}
    if "route_gap" in ref:
        out["route_gap"] = ref["route_gap"]
    diff = None
    if "first_grads" in prog and "first_grads" in ref:
        diff = relative_diffs(prog["first_grads"], ref["first_grads"], device)
        out["grad_diff_median"] = statistics.median(diff)
        out["grad_diff_least"] = min(diff)
        out["grad_diff"] = max(diff)
    out["by_leaf"] = {".".join(p): [grad[i], change.get(i), diff[i] if diff else None]
                      for i, p in enumerate(paths)}
    return out


def reference(conf, seed, dev, mix, mm=None, loss_fn=None, keep_grads=False,
              routes=None) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = traffic.TrainBatches(mix, conf["vocab_size"], seed)
    batches = []
    for s in range(mix["check_steps"]):
        b = src.batch(s)
        batches.append({k: torch.from_numpy(v).to(dev) for k, v in b.items()})
    kw = {}
    if mm is not None:
        kw["mm"] = mm
    if loss_fn is not None:
        kw["loss_fn"] = loss_fn
    return common.reference(conf).train(conf, seed, batches, mix["optimizer"], dev,
                                        keep_grads=keep_grads, routes=routes, **kw)


def check(ctx, conf, seed, dev, mix, prog) -> dict:
    """The numbers the cell's limits file names, each beside its limit; the
    others are reported under ``extra``.  With ``ctx.control`` (calibration
    only), also the readings of the control (the reference with float8
    matrix products, against the reference on the control's routing), of
    the fault of a loss over half the rows, and, of a mixture of experts,
    the program's against the reference on its own routing (the witness of
    what routing alone does to the numbers)."""
    t = time.monotonic()
    keep = "first_grads" in prog
    routes = prog.get("routes")
    ref = reference(conf, seed, dev, mix, keep_grads=keep, routes=routes)
    plain = common.reference(conf)
    paths = plain.leaf_paths(conf)

    def readings_of(got, want):
        return readings(got, want, paths, dev, plain.relative_diffs)

    r = readings_of(prog, ref)
    ctx.extra.update(reference_s=time.monotonic() - t, readings=r,
                     losses=prog["losses"], reference_losses=ref["losses"])
    if ctx.control:
        import torch

        if routes is not None:
            ctx.extra["own_routing"] = readings_of(
                prog, reference(conf, seed, dev, mix, keep_grads=keep))
        ctl = reference(conf, seed, dev, mix, keep_grads=keep, mm=plain.fp8_matmul)
        ctl_ref = (reference(conf, seed, dev, mix, keep_grads=keep, routes=ctl["routes"])
                   if routes is not None else ref)
        ctx.extra["control"] = readings_of(ctl, ctl_ref)
        del ctl, ctl_ref
        half = readings_of(reference(conf, seed, dev, mix, keep_grads=keep,
                                     loss_fn=half_batch_loss), ref)
        half.pop("route_gap", None)   # the half batch routes rows the reference never saw
        ctx.extra["half_batch"] = half
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {name: {"value": r[name], "limit": limit} for name, limit in ctx.limits.items()}


def half_batch_loss(params, batch, conf, mm, **_):
    """A fault planted in the reference put in the program's place: the
    loss of the first half of the rows only, their mean."""
    half = {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}
    return common.reference(conf).train_loss(params, half, conf, mm)
