"""The scan engine: rounds replayed from CUDA graphs (counterpart of the JAX
package's compiled ``lax.scan`` over rounds).

``EngineSpec(engine="scan")`` runs each round as its host stage
(``server.round_stage``) and its device body (``server.round_body``).  The
engine owns static buffers: the carry (model, server state, the iterate
tail, the watchdog's ``fault_t``), one set of staged inputs for each of the
``scan_unroll`` rounds a graph holds, and a (chunk, 12) table of the rounds'
telemetry payloads, whose columns 0-3 are also the histories.  A graph
holds ``scan_unroll`` rounds of one kind (the eval cadence decides a
round's kind; a group is a tuple of kinds): each round reads its staged
inputs, runs the body, resolves the watchdog (a round that trips is not
committed; later rounds commit nothing and record NaN), writes its payload
row and commits the carry into the static buffers.  Before each replay the
stage draws the group's rounds on the host and copies them into the
static inputs; the host reads the payload table once a chunk.

A graph is captured the first time its kind runs, after one uncaptured
warm-up of the body on the capture stream (it builds and caches what a
first launch makes).  A body that synchronises with the host (a
``.item()``, a pageable copy, a shape read from the device) fails the
capture, and the engine runs it again under PyTorch's sync debug mode
``"error"`` to name the operation; one that copies a host tensor in
(``host_to_device``) raises in the capture.  Either is a ``CaptureError``;
there is no fallback to the eager loop.  Graphs are
kept for the session: every later chunk, run, seed of ``run_batched`` and
``resume`` replays them.  The kernels' Python launch counters count at
warm-up and capture; the engine takes the capture's counts back and adds
them once a replay, so a counter reads the launches that ran.

On the CPU the same stage, body and commit run uncaptured, so a CPU
session exercises the code the card replays.
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Callable

import torch

from repro_torch.core.algorithm import round_generator
from repro_torch.fedsim import server as _srv
from repro_torch.tree import tree_map

__all__ = ["ScanEngine", "launch_counts", "CaptureError"]

PAYLOAD_LEN = 12
_HIST_COLS = (0, 3, 1, 2)   # eta, metric, eta_naive, eta_target of a payload row


class CaptureError(RuntimeError):
    """The round body did something a CUDA graph cannot replay."""


def _counter_fns():
    from repro_torch.kernels.dp_aggregate import ops as agg
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssd_scan import ops as ssd
    return (agg.dp_aggregate_sums, agg.generate_ldp_noise, flash.flash_attention, ssd.ssd_scan)


def launch_counts() -> dict[tuple[int, str], int]:
    """Every kernel wrapper's launch counters, keyed by (wrapper, name)."""
    return {(i, k): v for i, fn in enumerate(_counter_fns())
            for k, v in vars(fn).items() if "launches" in k and isinstance(v, int)}


def _add_counts(delta: dict, times: int = 1) -> None:
    fns = _counter_fns()
    for (i, k), v in delta.items():
        setattr(fns[i], k, getattr(fns[i], k) + times * v)


def _flatten(tree):
    """(tensor leaves, rebuild) of a carry: tensors, tuples, lists, dicts and
    dataclasses of them."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        parts = [_flatten(getattr(tree, n)) for n in names]
        sizes = [len(p[0]) for p in parts]

        def rebuild(leaves, tree=tree):
            vals, i = {}, 0
            for n, (_, fn), k in zip(names, parts, sizes):
                vals[n] = fn(leaves[i:i + k])
                i += k
            return dataclasses.replace(tree, **vals)
        return [x for p in parts for x in p[0]], rebuild
    if isinstance(tree, (tuple, list, dict)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        parts = [_flatten(tree[k]) for k in keys]
        sizes = [len(p[0]) for p in parts]

        def rebuild(leaves, tree=tree):
            vals, i = [], 0
            for (_, fn), k in zip(parts, sizes):
                vals.append(fn(leaves[i:i + k]))
                i += k
            if isinstance(tree, dict):
                return dict(zip(keys, vals))
            return type(tree)(vals)
        return [x for p in parts for x in p[0]], rebuild
    return [], lambda leaves, tree=tree: tree


def _copy_into(static, fresh, where: str):
    """Copy the staged round ``fresh`` into the engine's buffers ``static``
    (the same structure) and return them.  A field whose presence, shape or
    value (a non-tensor) differs from the buffers' would not replay: it
    raises."""
    if isinstance(fresh, torch.Tensor):
        if not isinstance(static, torch.Tensor) or static.shape != fresh.shape \
                or static.dtype != fresh.dtype:
            raise CaptureError(f"{where}: a {tuple(fresh.shape)} {fresh.dtype} input where the "
                               f"captured round read {_describe(static)}")
        static.copy_(fresh)
        return static
    if dataclasses.is_dataclass(fresh) and not isinstance(fresh, type):
        for f in dataclasses.fields(fresh):
            _copy_into(getattr(static, f.name), getattr(fresh, f.name), f"{where}.{f.name}")
        return static
    if isinstance(fresh, (tuple, list)):
        if not isinstance(static, (tuple, list)) or len(static) != len(fresh):
            raise CaptureError(f"{where}: {type(fresh).__name__} of {len(fresh)} where the "
                               f"captured round read {_describe(static)}")
        for i, (a, b) in enumerate(zip(static, fresh)):
            _copy_into(a, b, f"{where}[{i}]")
        return static
    if static is not fresh and static != fresh:
        raise CaptureError(f"{where}: {fresh!r} where the captured round read {static!r}; "
                           "a value that changes from round to round must be a tensor")
    return static


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"a {tuple(x.shape)} {x.dtype} tensor"
    return repr(x)


def _root(exc: BaseException) -> BaseException:
    """The first exception of ``exc``'s chain: a failed capture's own error,
    not the one its context manager raised while closing the capture."""
    while exc.__context__ is not None:
        exc = exc.__context__
    return exc


def _where_user(exc: BaseException) -> str:
    """The innermost frame of ``exc``'s traceback outside torch: where the
    body did what the graph cannot replay."""
    frames = traceback.extract_tb(exc.__traceback__)
    own = [f for f in frames if "/torch/" not in f.filename.replace("\\", "/")]
    f = (own or frames)[-1]
    return f"{f.filename}:{f.lineno} in {f.name}: {(f.line or '').strip()}"


@dataclasses.dataclass
class _Static:
    w: torch.Tensor
    state_leaves: list
    rebuild: Callable
    tail: torch.Tensor          # (avg_last, d): the newest iterate last
    fault_t: torch.Tensor       # 0-d int64, -1 while healthy
    rows: torch.Tensor          # (chunk, 12) payload rows
    pos: torch.Tensor           # (1,) int64: the next row
    inputs: list                # one staged RoundInputs a round of a group


class ScanEngine:
    """The scan engine of one session (built by ``FederatedSession``)."""

    def __init__(self, algorithm, local_fn, eval_fn, *, eval_every: int, cohort, fault,
                 tau: int, avg_last: int, eta_l: float, unroll: int, num_clients: int,
                 device, chunk_cap: int):
        self.algorithm = algorithm
        self.stage = _srv.round_stage(algorithm, local_fn, cohort, fault)
        self.body = _srv.round_body(algorithm, local_fn, eval_fn, eval_every, cohort, fault,
                                    tau)
        self.eval_fn, self.eval_every = eval_fn, eval_every
        self.fault = fault if fault is not None and fault.watchdog else None
        self.avg_last, self.eta_l, self.unroll = avg_last, eta_l, unroll
        self.num_clients, self.device = num_clients, torch.device(device)
        self.chunk_cap = chunk_cap
        self.cuda = self.device.type == "cuda"
        self.static: _Static | None = None
        self.batches = None
        self._own_batches = None
        self.graphs: dict[tuple, tuple] = {}
        self.replays = 0
        self.captures = 0
        if self.cuda:
            self.capture_stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    # -- buffers ----------------------------------------------------------------

    def _kind(self, t: int) -> bool:
        """A round's kind: whether the eval cadence evaluates it."""
        return self.eval_fn is not None and (t + 1) % self.eval_every == 0

    def _load(self, carry, client_batches) -> None:
        """Copy ``carry`` into the static buffers (made the first time) and
        bind the client data the graphs read."""
        w, state, tail = carry
        leaves, rebuild = _flatten(state)
        if self.static is None:
            d = w.shape[-1]
            self.static = _Static(
                w=w.clone(), state_leaves=[x.clone() for x in leaves], rebuild=rebuild,
                tail=w.new_zeros((self.avg_last, d)),
                fault_t=torch.full((), -1, dtype=torch.int64, device=self.device),
                rows=torch.full((self.chunk_cap, PAYLOAD_LEN), float("nan"),
                                dtype=torch.float32, device=self.device),
                pos=torch.zeros(1, dtype=torch.int64, device=self.device), inputs=[])
        st = self.static
        if len(leaves) != len(st.state_leaves):
            raise CaptureError("the server state's structure changed between runs")
        st.w.copy_(w)
        for a, b in zip(st.state_leaves, leaves):
            a.copy_(b)
        st.tail.zero_()
        if tail:
            st.tail[self.avg_last - len(tail):].copy_(torch.stack(list(tail)))
        st.fault_t.fill_(-1)
        st.pos.zero_()
        if self.batches is None:
            self._own_batches = client_batches
            self.batches = client_batches
        elif client_batches is not self.batches:
            if self.batches is self._own_batches and client_batches is not self._own_batches:
                # per-seed data (run_batched): the graphs read a buffer of their own
                self.batches = tree_map(lambda x: x.clone(), client_batches)
                self.graphs.clear()
            elif client_batches is self._own_batches:
                self.batches = client_batches
                self.graphs.clear()
            else:
                tree_map(lambda a, b: a.copy_(b), self.batches, client_batches)

    # -- one group of rounds ------------------------------------------------------

    def _round(self, k: int, t: int) -> None:
        """Round ``t`` of a group, on the static buffers: the body, the
        watchdog, the payload row, the commit."""
        st = self.static
        inp = st.inputs[k]
        w, state = st.w, st.rebuild(st.state_leaves)
        w_next, state_next, out = self.body(w, state, inp, t, self.batches, self.eta_l)
        new_leaves, _ = _flatten(state_next)
        tail_next = torch.cat([st.tail[1:], w_next[None]])
        fault_t = st.fault_t
        out = tuple(torch.as_tensor(o, dtype=torch.float32).to(self.device).reshape(())
                    for o in out)
        if self.fault is not None:
            tripped = st.fault_t >= 0
            eta = out[0]
            healthy = (torch.isfinite(w_next).all() & torch.isfinite(eta)
                       & (eta <= self.fault.eta_max))
            commit = ~tripped & healthy
            fault_t = torch.where(~tripped & ~healthy, inp.t, st.fault_t)
            w_next = torch.where(commit, w_next, w)
            new_leaves = [torch.where(commit, b, a) for a, b in zip(st.state_leaves, new_leaves)]
            tail_next = torch.where(commit, tail_next, st.tail)
            out = tuple(torch.where(tripped, torch.full_like(o, float("nan")), o) for o in out)
        payload = _srv.tap_payload(self.algorithm, state, out, inp.counts, fault_t)
        st.rows.index_copy_(0, st.pos, payload[None])
        st.pos.add_(1)
        st.w.copy_(w_next)
        for a, b in zip(st.state_leaves, new_leaves):
            a.copy_(b)
        st.tail.copy_(tail_next)
        st.fault_t.copy_(fault_t)

    def _group(self, ts) -> None:
        for k, t in enumerate(ts):
            self._round(k, t)

    def _bodies(self, ts) -> None:
        """The group's bodies, uncaptured, their results dropped."""
        st = self.static
        for k, t in enumerate(ts):
            self.body(st.w, st.rebuild(st.state_leaves), st.inputs[k], t, self.batches,
                      self.eta_l)

    def _synchronising_op(self, ts) -> str | None:
        """Where the group's bodies synchronise with the host, found by
        running them under PyTorch's sync debug mode "error" (after a failed
        capture), or None."""
        torch.cuda.set_sync_debug_mode("error")
        try:
            self._bodies(ts)
        except RuntimeError as exc:
            return f"{_where_user(exc)}, which synchronises with the host ({exc})"
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return None

    def _graph_for(self, ts):
        key = tuple(self._kind(t) for t in ts)
        if key in self.graphs:
            return self.graphs[key]
        cur = torch.cuda.current_stream(self.device)
        self.capture_stream.wait_stream(cur)
        with torch.cuda.stream(self.capture_stream):
            # builds and caches what a first launch makes (libraries, launch
            # plans, the capture stream's tickets, cuBLAS's workspace)
            self._bodies(ts)
        cur.wait_stream(self.capture_stream)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.capture_stream):
                self._group(ts)
        except RuntimeError as exc:
            root = _root(exc)
            torch.cuda.synchronize(self.device)
            where = self._synchronising_op(ts) or f"{_where_user(root)} ({root})"
            raise CaptureError(f"the scan engine cannot capture round {ts[0]}: "
                               f"{where}") from exc
        after = launch_counts()
        delta = {k: after[k] - before.get(k, 0) for k in after}
        _add_counts(delta, -1)       # nothing ran at capture
        self.captures += 1
        self.graphs[key] = (graph, delta)
        return self.graphs[key]

    # -- a chunk ------------------------------------------------------------------

    def run_chunk(self, carry, seed: int, start: int, end: int, client_batches, *,
                  timing: bool = False):
        """Rounds ``[start, end)`` from ``carry`` (``(w, state, tail list)``).

        Returns ``(carry, hist, fault_round, rows, times)``: the carry after
        the chunk (copies), the four (n,) histories on the device,
        ``fault_round`` (the watchdog's round, or None), the (n, 12)
        payload rows on the device, and with ``timing`` each round's seconds
        (CUDA events between graph replays on the card, each graph's time
        split evenly among its rounds; ``perf_counter`` on the CPU), else
        None."""
        n = end - start
        if n > self.chunk_cap:
            raise ValueError(f"a chunk of {n} rounds exceeds the engine's {self.chunk_cap}")
        self._load(carry, client_batches)
        st = self.static
        d = st.w.shape[-1]
        times = [] if timing else None
        marks = []
        if timing and self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((ev, 0))
        t0 = time.perf_counter()
        for g0 in range(start, end, self.unroll):
            ts = list(range(g0, min(g0 + self.unroll, end)))
            for k, t in enumerate(ts):
                inp = self.stage(round_generator(seed, t), t, self.num_clients, d, self.device,
                                 payload=True)
                if k < len(st.inputs):
                    _copy_into(st.inputs[k], inp, f"round {t}'s staged inputs")
                else:
                    st.inputs.append(_clone(inp))
            if self.cuda:
                graph, delta = self._graph_for(ts)
                graph.replay()
                _add_counts(delta)
                self.replays += 1
                if timing:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    marks.append((ev, len(ts)))
            else:
                self._group(ts)
                if timing:
                    now = time.perf_counter()
                    times.extend([(now - t0) / len(ts)] * len(ts))
                    t0 = now
        rows = st.rows[:n].clone()
        hist = tuple(rows[:, c] for c in _HIST_COLS)
        fault_round = None
        if self.fault is not None:
            ft = int(st.fault_t)
            fault_round = ft if ft >= 0 else None
        committed = n if fault_round is None else fault_round - start
        w = st.w.clone()
        state = st.rebuild([x.clone() for x in st.state_leaves])
        had = len(carry[2])
        keep = min(self.avg_last, had + committed)
        tail = [st.tail[self.avg_last - keep + i].clone() for i in range(keep)]
        if timing and self.cuda:
            marks[-1][0].synchronize()
            for (a, _), (b, k) in zip(marks[:-1], marks[1:]):
                times.extend([a.elapsed_time(b) / 1e3 / k] * k)
        return (w, state, tail), hist, fault_round, rows, times
