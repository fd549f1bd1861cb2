"""The serving driver: one cell of a ``"kind": "serve"`` mix through the
program's production path, ``ClusterServingEngine`` driven by
``submit_request`` with worker-driven decode loops on thread workers.

Set-up makes the weights from the seed, builds the engine and serves the
mix's warm-up requests (every prompt length from the shortest to the
longest, each for one whole decode block).  Then:

* a backlog (``arrivals.process`` ``backlog``) is submitted at once; the
  window opens at the first delivery ``fill_s`` later, once the slots have
  filled, and closes at the first delivery at or after ``seconds`` (tokens
  arrive a decode block at a time, and a close between deliveries would
  count a fraction of a block as nothing).  The job ends there: what it had
  not finished is cut off, and what it had not begun was not attempted;
* an open-loop mix offers each request at its due time from the window's
  open, and every request due in the window is followed past the close
  for up to ``follow_s``; one that fails, is shed or has not ended by then
  counts as missing (infinitely late).

Metrics, all on the host's clock (``time.monotonic``, the clock the engine
stamps token arrivals with): ``tokens_per_s``, the tokens that reached the
client in the window over it; ``ttft_ms_p95``, the 95th percentile over the
requests due in the window of the time from when each was due to its first
token's arrival; ``tpot_ms_p95``, the 95th percentile over the same
requests of (last token - first token) / (tokens - 1).  A cell reports
those ``BENCHMARK.json`` gives it; the others go under ``extra``.

``correct``: once the program's state is freed, a sample of the finished
requests drawn from the seed (the one with the most served tokens among
them) is run through the plain float32 reference whole (the module the
configuration's ``reference`` names), and the widest gap by which a served
token's reference logit lies below the reference's best at its position is
compared with the cell's limit; every finished request must also hold
exactly its budget of in-vocabulary tokens, and no request begun may fail.

A mixture of experts is compared on the program's routing, as training is:
before its state is freed, the program's own forward pass over each
sampled sequence records the experts it chooses (``adapter.RouteRecorder``),
the reference takes them, and each choice is judged against the
reference's router (``route_gap``).  That pass is the program's routing of
each sequence whole, as a prefill routes it; the decode steps that served
most tokens replay a CUDA graph that no recorder sees, so their routing is
judged only through the tokens' logits.  Calibration adds the gap on the
reference's own routing under ``extra``.  The program applies capacity per
call (a prompt at its admission, each decode step) and the reference over
the whole sequence, so a configuration whose capacity lets the program
drop pairs is refused before anything runs.
"""

from __future__ import annotations

import gc
import math
import resource
import time

import numpy as np

from portbench import adapter, common, traffic

WARM_RID = 1 << 40


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    import torch

    from repro_torch.core.flags import STREAM_DONE
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ClusterServingEngine, Request

    from portbench import program, trace

    conf, mix, seed, seconds = ctx.conf, ctx.mix, ctx.seed, ctx.seconds
    dev = torch.device(ctx.device)
    V = conf["vocab_size"]
    wdt = getattr(torch, conf["param_dtype"])
    reqs = traffic.serve_requests(mix, V, seed, seconds)
    warm = traffic.warmup_requests(mix, V, seed)
    spec = {r["rid"]: r for r in reqs}

    cfg = program.model_config(conf)
    refuse_dropping(conf, cfg)
    model = build_model(cfg, device=dev)
    params = common.reference(conf).make_weights(conf, seed, dev, wdt)
    e = mix["engine"]
    eng = ClusterServingEngine(model, params, num_workers=e["workers"],
                               slots_per_worker=e["slots_per_worker"], max_len=e["max_len"],
                               seed=seed % (1 << 31), decode_block=e["decode_block"],
                               device=dev)
    out = {}
    try:
        rids = [eng.submit_request(Request(prompt=r["prompt"], max_new_tokens=r["max_new"],
                                           rid=WARM_RID + r["rid"]), shed=False)
                for r in warm]
        eng.wait(rids, timeout=600)
        if ctx.trace:
            trace.prime(dev)
        _sync(dev)
        out["setup_s"] = time.monotonic() - ctx.t_start

        backlog = mix["arrivals"]["process"] == "backlog"
        t_sub = time.monotonic()
        late, submitted, refused = [], [], []

        def submit(r, due):
            late.append(time.monotonic() - due)
            try:
                eng.submit_request(Request(prompt=r["prompt"], max_new_tokens=r["max_new"],
                                           rid=r["rid"]))
                submitted.append(r["rid"])
            except Exception as exc:  # noqa: BLE001 — shed or refused: missing
                refused.append((r["rid"], repr(exc)))

        if backlog:
            # the whole backlog is due at once; the window opens at the first
            # delivery once the slots have filled (``fill_s``), so it measures
            # the steady state and not the first admissions
            for r in reqs:
                submit(r, t_sub)
            t0 = first_delivery(eng, t_sub + mix["fill_s"])
        else:
            t0 = t_sub
        out["setup_s"] = t0 - ctx.t_start
        use0 = resource.getrusage(resource.RUSAGE_SELF)
        tracer = None
        if ctx.trace:
            tracer = trace.ServeSlice(dev, eng.sched, adapter.replicas(eng)[0],
                                      start_at=t0 + mix["profile"]["start_share"] * seconds,
                                      blocks=mix["profile"]["blocks"],
                                      loops=adapter.loops(eng),
                                      host_blocks=mix["profile"].get("host_blocks", 0))
        if not backlog:
            for r in reqs:
                due = t0 + r["due"]
                wait = due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                submit(r, due)
        t_close = t0 + seconds
        time.sleep(max(0.0, t_close - time.monotonic()))
        use1 = resource.getrusage(resource.RUSAGE_SELF)
        queue_at_close = len(adapter.queued(eng)) + adapter.worker_queue(eng)
        unstarted = sum(1 for rid in submitted if not adapter.token_times(eng, rid))
        if backlog:
            # the window closes at the first delivery at or after its time.
            # The batch job ends there: what it had not finished is cut off
            # (cancelled) and, if not begun by then, was never attempted
            t_end = first_delivery(eng, t_close)
            attempted = [rid for rid in submitted
                         if adapter.token_times(eng, rid)[:1] <= [t_end]
                         and adapter.token_times(eng, rid)]
            cut = {rid for rid in submitted if adapter.status(eng, rid) is None}
            for rid in cut:
                eng.cancel(rid)
        else:
            attempted, cut = list(submitted), set()
            try:
                eng.wait(attempted, timeout=mix["follow_s"])
            except Exception as exc:  # noqa: BLE001 — counted per request below
                print(f"serve: after the close: {exc!r}", flush=True)
        record = None
        if tracer is not None:
            deadline = time.monotonic() + 60
            while not tracer.done and time.monotonic() < deadline:
                time.sleep(0.05)
            tracer.restore()
            record = tracer.record(conf, mix) if tracer.done else None
            tracer = None
        _sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

        times = {rid: adapter.token_times(eng, rid) for rid in attempted}
        texts = {rid: adapter.transcript(eng, rid) for rid in attempted}
        done = {rid: adapter.status(eng, rid) == STREAM_DONE
                and adapter.error(eng, rid) is None for rid in attempted}
        lost = [rid for rid in attempted if not done[rid] and rid not in cut]
    finally:
        loops = adapter.loops(eng)
        eng.close()
    adapter.wait_ended(loops)
    picked, seqs, malformed = compared(ctx.mix, seed, V, spec, attempted, texts, done)
    routes = program_routes(model, params, seqs, dev) if cfg.moe is not None else None
    del eng, model, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    failed = lost + [rid for rid, _ in refused]
    n_attempted = len(attempted) + len(refused)
    if backlog:
        tokens = sum(1 for ts in times.values() for t in ts if t0 < t <= t_end)
    else:
        tokens, t_end = common.delivered([t for ts in times.values() for t in ts], t0, t_close)
    out["tokens_per_s"] = tokens / (t_end - t0)
    ttft, tpots = [], []
    for rid in attempted:
        if rid in cut:
            continue
        ts = times[rid]
        ok = done[rid] and len(ts) == spec[rid]["max_new"]
        ttft.append(1e3 * (ts[0] - (t0 + spec[rid]["due"])) if ok else math.inf)
        tpots.append(1e3 * common.tpot(ts[0], ts[-1], len(ts)) if ok and len(ts) > 1
                     else math.inf)
    ttft += [math.inf] * len(refused)
    tpots += [math.inf] * len(refused)
    out["ttft_ms_p95"] = common.percentile(ttft, 95) if ttft else math.inf
    out["tpot_ms_p95"] = common.percentile(tpots, 95) if tpots else math.inf
    out["generator"] = {"requests_due": len(reqs), "late_ms_p95": 1e3 * common.percentile(late, 95),
                        "late_ms_max": 1e3 * max(late), "refused": len(refused),
                        "window_s": t_end - t0, "queue_at_close": queue_at_close,
                        "unstarted_at_close": unstarted}
    # how steady the host was: the process's CPU time over the window (every
    # thread), and the gaps between deliveries (a decode block's tokens
    # arrive within a few milliseconds of each other)
    arrivals = sorted(t for ts in times.values() for t in ts if t0 <= t <= t_end)
    blocks = [b for a, b in zip(arrivals, arrivals[1:]) if b - a > 0.05]
    gaps = [b - a for a, b in zip(blocks, blocks[1:])]
    out["host"] = {"cpu_s": (use1.ru_utime + use1.ru_stime) - (use0.ru_utime + use0.ru_stime),
                   "deliveries": len(blocks),
                   "delivery_gap_s_p50": common.percentile(gaps, 50) if gaps else None,
                   "delivery_gap_s_p90": common.percentile(gaps, 90) if gaps else None}
    out["completions_per_s"] = sum(1 for rid in attempted if done[rid] and times[rid]
                                   and times[rid][-1] <= t_end) / (t_end - t0)

    checks = check(ctx, conf, seed, dev, wdt, spec, texts, picked, seqs, malformed, routes)
    checks["lost_requests"] = {"value": len(lost), "limit": 0}
    return {"metrics": out, "attempted": n_attempted, "failed": len(failed),
            "memory_peak_bytes": peak, "checks": checks, "record": record}


def first_delivery(engine, after: float, timeout: float = 120.0) -> float:
    """The first time at or after ``after`` that tokens reached the client,
    waiting for it."""
    deadline = time.monotonic() + timeout
    time.sleep(max(0.0, after - time.monotonic()))
    while True:
        t = adapter.first_arrival(engine, after)
        if t is not None:
            return t
        if time.monotonic() > deadline:
            raise TimeoutError("no token reached the client")
        time.sleep(0.02)


def sample(seed: int, finished: list, texts: dict, min_tokens: int, min_requests: int,
           max_requests: int) -> list:
    """Finished requests for the comparison: the one with the most served
    tokens, then others in an order drawn from the seed, until there are
    ``min_tokens`` served tokens and ``min_requests`` requests, or
    ``max_requests`` requests."""
    if not finished:
        return []
    longest = max(finished, key=lambda rid: (len(texts[rid]), -rid))
    rest = [rid for rid in finished if rid != longest]
    order = traffic.rng(seed, 4).permutation(len(rest))
    picked, n = [longest], len(texts[longest])
    for i in order:
        if (n >= min_tokens and len(picked) >= min_requests) or len(picked) >= max_requests:
            break
        picked.append(rest[i])
        n += len(texts[rest[i]])
    return picked


def refuse_dropping(conf: dict, cfg) -> None:
    """Refuse a mixture of experts whose capacity (the program's, or the
    configuration's that the reference takes) lets pairs be dropped: below
    E/k an expert can overflow.  The program drops per call and the
    reference over the whole sequence, so the two would not compute one
    model."""
    moe = cfg.moe
    if moe is None:
        return
    for cf in (moe.capacity_factor, conf.get("capacity_factor", moe.capacity_factor)):
        if cf * moe.top_k < moe.num_experts:
            raise ValueError(
                f"{conf['name']}: capacity_factor {cf} is below num_experts / top_k = "
                f"{moe.num_experts}/{moe.top_k}; serving is compared only where no "
                f"(token, choice) pair can be dropped")


def compared(mix, seed, V, spec, attempted, texts, done) -> tuple:
    """(picked, seqs, malformed): the sampled finished requests, each one's
    prompt and served tokens but the last (int32), and the count of
    finished requests that do not hold exactly their budget of
    in-vocabulary tokens."""
    import torch

    finished = [rid for rid in attempted if done[rid]]
    good = [rid for rid in finished if len(texts[rid]) == spec[rid]["max_new"]
            and all(0 <= t < V for t in texts[rid])]
    c = mix["check"]
    picked = sample(seed, good, texts, c["min_tokens"], c["min_requests"], c["max_requests"])
    seqs = [torch.from_numpy(np.concatenate([spec[rid]["prompt"],
                                             np.asarray(texts[rid][:-1], np.int32)]))
            for rid in picked]
    return picked, seqs, len(finished) - len(good)


def program_routes(model, params, seqs, dev) -> list:
    """The experts the program chooses for each sequence in its own
    forward pass over it, whole: per sequence, its routing calls in order
    (one (G, Tg, k) tensor a layer), on the host."""
    import torch

    routes = []
    with adapter.RouteRecorder() as rec, torch.no_grad():
        for seq in seqs:
            model.forward(params, {"tokens": seq[None].to(dev)})
            routes.append(rec.take())
    return routes


def readings(picked, spec, texts, lgs, chosen=None) -> dict:
    """The numbers of the tokens chosen at each served position (the
    served ones, or ``chosen``: one tensor a request) judged by ``lgs`` (one
    (S, V) tensor a sampled request): the widest gap by which a chosen
    token's logit lies below the best at its position (``logit_gap``), the
    mean gap (``logit_gap_mean``), and the share of positions whose chosen
    token is not the best (``off_argmax_share``)."""
    import torch

    gaps = []
    for j, (rid, lg) in enumerate(zip(picked, lgs)):
        P, n = len(spec[rid]["prompt"]), len(texts[rid])
        rows = lg[P - 1:P - 1 + n]
        tok = torch.tensor(texts[rid], device=lg.device) if chosen is None else chosen[j]
        gaps.append(rows.max(-1).values - rows.gather(-1, tok[:, None])[:, 0])
    if not gaps:
        return {"logit_gap": 0.0, "logit_gap_mean": 0.0, "off_argmax_share": 0.0}
    g = torch.cat(gaps).double()
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
            "off_argmax_share": float((g > 0).double().mean())}


def check(ctx, conf, seed, dev, wdt, spec, texts, picked, seqs, malformed, routes) -> dict:
    """The numbers the cell's limits file names, each beside its limit;
    the others are reported under ``extra`` (``readings``).  A mixture of
    experts is judged on the program's routing (``routes``), which adds
    ``route_gap``.  With ``ctx.control`` (calibration only), also the same
    tokens judged on the reference's own routing (``own_routing``, the
    witness of why routing is followed) and the control's readings
    (``control``): the reference with
    float8 matrix products in the program's place, at each position the
    token it puts first, judged by the reference (of a mixture of experts,
    the reference on the control's routing, whose choices give the
    control's ``route_gap``)."""
    import torch

    ref = common.reference(conf)
    c = ctx.mix["check"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.monotonic()
    moe = routes is not None
    seen: dict = {}
    lg = ref.logits(conf, seed, seqs, dev, wdt, routes=routes, seen=seen)
    r = readings(picked, spec, texts, lg)
    if moe:
        r["route_gap"] = seen.get("route_gap", 0.0)
    checks = {name: {"value": r[name], "limit": limit} for name, limit in ctx.limits.items()}
    checks["malformed_requests"] = {"value": malformed, "limit": 0}
    checks["compared_requests"] = {"value": len(picked), "limit": c["min_requests"]}
    extra = {"compared_tokens": sum(len(texts[rid]) for rid in picked), "readings": r}
    extra["reference_s"] = time.monotonic() - t
    if ctx.control:
        if moe:
            # the witness: the same tokens judged on the reference's own routing
            extra["own_routing"] = readings(picked, spec, texts,
                                            ref.logits(conf, seed, seqs, dev, wdt))
        cseen: dict = {}
        ctl = ref.logits(conf, seed, seqs, dev, wdt, mm=ref.fp8_matmul, seen=cseen)
        chosen = [cl[len(spec[rid]["prompt"]) - 1:
                     len(spec[rid]["prompt"]) - 1 + len(texts[rid])].argmax(-1)
                  for rid, cl in zip(picked, ctl)]
        del ctl
        judge, jseen = lg, {}
        if moe:
            judge = ref.logits(conf, seed, seqs, dev, wdt, routes=cseen["routes"], seen=jseen)
        extra["control"] = readings(picked, spec, texts, judge, chosen)
        if moe:
            extra["control"]["route_gap"] = jseen.get("route_gap", 0.0)
    ctx.extra.update(extra)
    return checks
