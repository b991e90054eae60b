# The port's own copy of risc0_tpu/parallel/scheduler.py.
"""Distributed proving scheduler — the actor-cluster replacement.

Mirrors the reference's kameo actor system structure (r0vm/src/actors/
{manager,factory,worker}.rs + job/proof.rs) with a host-side task scheduler:

  * tasks are *pulled* by workers subscribing to task kinds (reference
    protocol.rs:163-166 GetTask{worker_id, kinds}), giving natural load
    balancing;
  * a ProofJob runs the streaming DAG: Execute emits segments ->
    ProveSegment -> Lift -> greedy adjacent-range binary Join tree
    (job/proof.rs:307-326) -> Union tree over coprocessor receipts
    (union_peak.rs) -> Resolve chain for recorded assumptions;
  * heterogeneous pools: execute/preflight on CPU workers, prove/lift/join
    on accelerator workers (reference actors/worker.rs:78-607), which share
    one card as threads of one process.

On one host this runs with thread pools; the same task protocol serializes
over sockets for multi-host deployment (segments are MB-scale payloads,
receipts ~100-300KB).

The union tree merges the coprocessor receipts in the order the guest
assumed them, the shape of recursion_driver.MerkleMountainAccumulator
(receipt.keccak_root_claim), whatever order their proves end in.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable

import numpy as np


def _claim_digest(receipt) -> np.ndarray:
    """Claim digest of a receipt whose claim is a claims object (works for
    both real SuccinctReceipts and dev-mode FakeReceipts)."""
    c = receipt.claim
    c = c() if callable(c) else c
    return np.asarray(c if isinstance(c, np.ndarray) else c.digest(),
                      np.uint32)


class TaskKind(Enum):
    EXECUTE = "execute"
    PREFLIGHT = "preflight"    # CPU half of segment proving (witgen)
    PROVE_SEGMENT = "prove_segment"
    PROVE_KECCAK = "prove_keccak"
    LIFT = "lift"
    JOIN = "join"
    UNION = "union"
    RESOLVE = "resolve"
    UNWRAP = "unwrap"      # strip the PoVW WorkClaim wrapper
    SHRINK_WRAP = "shrink_wrap"


@dataclass
class Task:
    kind: TaskKind
    job_id: int
    payload: Any
    task_id: int = 0
    # telemetry: (trace_id, span_id) of the submitting job's span, so the
    # worker-side task span parents to the job even across threads
    # (reference actors/mod.rs OTel context propagation); submit time for
    # the queue-wait histogram, on time.perf_counter_ns (the tracer's clock)
    trace_ctx: tuple | None = None
    submit_ns: int = 0


@dataclass
class TaskDone:
    task: Task
    result: Any = None
    error: Exception | None = None


class Factory:
    """Task queue router by kind (reference actors/factory.rs:37-208)."""

    def __init__(self):
        from collections import deque

        self._tasks: dict[TaskKind, Any] = {k: deque() for k in TaskKind}
        self._done: dict[int, queue.Queue] = {}
        self._cv = threading.Condition()

    def submit(self, task: Task):
        from .. import telemetry

        if task.trace_ctx is None:
            task.trace_ctx = telemetry.tracer().ctx()
        task.submit_ns = task.submit_ns or time.perf_counter_ns()
        telemetry.metrics().inc("risc0_tasks_submitted",
                                kind=task.kind.value)
        with self._cv:
            self._tasks[task.kind].append(task)
            self._cv.notify_all()

    def _take(self, kinds):
        for k in kinds:
            if self._tasks[k]:
                return self._tasks[k].popleft()
        return None

    def get_task(self, kinds: list[TaskKind], timeout=0.05) -> Task | None:
        """Pull a task of any subscribed kind (reference GetTask)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._cv:
            while True:
                t = self._take(kinds)
                if t is not None:
                    return t
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)

    def job_channel(self, job_id: int) -> queue.Queue:
        with self._cv:
            return self._done.setdefault(job_id, queue.Queue())

    def task_done(self, done: TaskDone):
        self.job_channel(done.task.job_id).put(done)


class Worker:
    """Pulls tasks by kind and runs them through a processor
    (reference actors/worker.rs:101-132)."""

    def __init__(self, factory: Factory, kinds: list[TaskKind],
                 processor: Callable[[Task], Any], name="worker"):
        self.factory = factory
        self.kinds = kinds
        self.processor = processor
        self.name = name
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _run(self):
        from .. import log, telemetry

        mx = telemetry.metrics()
        while not self._stop.is_set():
            task = self.factory.get_task(self.kinds)
            if task is None:
                continue
            t0 = time.perf_counter_ns()
            if task.submit_ns:
                mx.observe("risc0_task_queue_seconds",
                           (t0 - task.submit_ns) / 1e9,
                           kind=task.kind.value)
            with telemetry.tracer().span(
                    f"task:{task.kind.value}", parent=task.trace_ctx,
                    job=task.job_id, task=task.task_id,
                    worker=self.name) as sp:
                try:
                    result = self.processor(task)
                    self.factory.task_done(TaskDone(task, result=result))
                    dt = (time.perf_counter_ns() - t0) / 1e9
                    mx.observe("risc0_task_run_seconds", dt,
                               kind=task.kind.value, status="ok")
                    log.event("task_done", worker=self.name,
                              kind=task.kind.value, job=task.job_id,
                              task=task.task_id, seconds=round(dt, 4))
                except Exception as e:  # propagate to the job
                    sp.fail(e)
                    self.factory.task_done(TaskDone(task, error=e))
                    mx.observe("risc0_task_run_seconds",
                               (time.perf_counter_ns() - t0) / 1e9,
                               kind=task.kind.value, status="error")
                    log.event("task_failed", worker=self.name,
                              kind=task.kind.value, job=task.job_id,
                              task=task.task_id, error=str(e))


@dataclass
class _LiftedRange:
    """Contiguous range of lifted/joined receipts (reference job/proof.rs)."""

    lo: int
    hi: int  # inclusive
    receipt: Any


class ProofJob:
    """Streaming proof DAG for one session
    (reference r0vm/src/actors/job/proof.rs:185-399)."""

    _next_id = [0]

    def __init__(self, factory: Factory, prover, env, elf: bytes,
                 receipt_kind: str = "succinct", coproc_receipts=None,
                 asset_addr=None, stream_keccak: bool = False,
                 split_preflight: bool = False):
        self.factory = factory
        self.prover = prover
        self.env = env
        self.elf = elf
        self.receipt_kind = receipt_kind
        # when set, segments are uploaded once to the cluster's asset
        # server and PROVE_SEGMENT payloads carry content-addressed refs;
        # remote workers resolve through their local cache so the bytes
        # cross the network at most once per host (parallel/assets.py)
        self.asset_addr = asset_addr
        self._asset_client = None
        # streaming keccak coprocessor (reference CoprocessorCallback +
        # r0vm actor keccak flow): PROVE_KECCAK tasks are submitted the
        # moment the guest flushes a batch, overlapping coprocessor
        # proving with the remainder of execution.  Local pools only —
        # the callback rides the env object, which then can't pickle.
        self.stream_keccak = stream_keccak
        # split segment proving into a CPU PREFLIGHT task and a device
        # PROVE_SEGMENT(core) task (reference ProverServer::
        # {segment_preflight, prove_segment_core}, prove/mod.rs:79-86 and
        # actors/worker.rs:569-592): host witgen of segment N+1 overlaps
        # device proving of segment N.  The preflight result holds the
        # exec witness and rides in the core task's payload.
        self.split_preflight = split_preflight
        self._outst_lock = threading.Lock()
        self._streamed = 0
        # PoVW mode: lift/join produce WorkClaim receipts threading the
        # per-segment nonces; the final receipt is unwrapped back to the
        # bare session claim (reference job/proof.rs povw task variants)
        self.povw = getattr(env, "povw_job_id", None) is not None
        self.work = None  # proven total Work (set when povw)
        # already-proven coprocessor receipts (e.g. keccak) to be merged
        # into one union receipt (reference job/proof.rs keccak path +
        # union_peak.rs MMR)
        self.coproc_receipts = list(coproc_receipts or [])
        self._keccak_tasks: list = []  # PROVE_KECCAK task ids, in order
        self.union_receipt = None
        self.max_retries = 2  # per-task transient-failure retries
        ProofJob._next_id[0] += 1
        self.job_id = ProofJob._next_id[0]
        self._task_counter = 0

    def _submit(self, kind: TaskKind, payload) -> int:
        with self._outst_lock:  # streamed submissions come from the
            self._task_counter += 1    # executing worker's thread
            task_id = self._task_counter
            if kind == TaskKind.PROVE_KECCAK:
                self._keccak_tasks.append(task_id)  # the guest's order
        self.factory.submit(Task(kind, self.job_id, payload,
                                 task_id=task_id))
        return task_id

    def run(self):
        """Run the DAG to completion; returns (session, final_receipt).
        The whole job runs under one root span; every task span parents
        to it via Task.trace_ctx (reference actors/mod.rs OTel init)."""
        from .. import telemetry

        t0 = time.perf_counter_ns()
        with telemetry.tracer().span("proof_job", job=self.job_id,
                                     receipt_kind=self.receipt_kind,
                                     povw=self.povw):
            out = self._run_dag()
        telemetry.metrics().inc("risc0_jobs_completed",
                                kind=self.receipt_kind)
        telemetry.metrics().observe("risc0_job_seconds",
                                    (time.perf_counter_ns() - t0) / 1e9,
                                    kind=self.receipt_kind)
        return out

    def _run_dag(self):
        from ..zkvm.claims import ExitCode
        from ..zkvm.receipt import segment_claim, session_segment_output

        chan = self.factory.job_channel(self.job_id)

        if self.receipt_kind == "composite" and self.povw:
            raise ValueError("PoVW work claims require the lift/join "
                             "(succinct) flow, not composite receipts")

        if self.stream_keccak:
            job = self

            class _StreamCoproc:
                def prove_keccak(self, req):
                    # runs on the executing worker's thread, strictly
                    # while the EXECUTE task is outstanding — so the
                    # count can never transit 0 spuriously
                    with job._outst_lock:
                        job._streamed += 1
                    job._submit(TaskKind.PROVE_KECCAK, req)

            self.env.coprocessor = _StreamCoproc()

        self._submit(TaskKind.EXECUTE, (self.env, self.elf))

        session = None
        outstanding = 1
        lifted: list[_LiftedRange] = []
        segment_receipts = {}  # composite mode: index -> SegmentReceipt
        segment_claims = {}

        def try_join():
            """Greedy adjacent-range binary join (job/proof.rs:307-326)."""
            nonlocal outstanding
            lifted.sort(key=lambda r: r.lo)
            i = 0
            while i + 1 < len(lifted):
                a, b = lifted[i], lifted[i + 1]
                if a.hi + 1 == b.lo:
                    self._submit(TaskKind.JOIN, (a, b, self.povw))
                    outstanding += 1
                    del lifted[i : i + 2]
                else:
                    i += 1

        retries: dict = {}
        keccak_receipts: dict = {}  # PROVE_KECCAK task id -> receipt
        while True:
            with self._outst_lock:
                # fold in keccak tasks streamed by the coprocessor hook
                outstanding += self._streamed
                self._streamed = 0
            if outstanding <= 0:
                break
            done: TaskDone = chan.get()
            outstanding -= 1
            if done.error is not None:
                # transient-failure recovery (reference manager retry /
                # dump-for-replay): resubmit up to max_retries, then fail
                n = retries.get(done.task.task_id, 0)
                if n < self.max_retries:
                    retries[done.task.task_id] = n + 1
                    self.factory.submit(done.task)
                    outstanding += 1
                    continue
                raise done.error
            task, result = done.task, done.result
            if task.kind == TaskKind.EXECUTE:
                session = result
                kind, *rest = session.exit_code
                session_exit = ExitCode(kind, rest[0] if rest else 0)
                # the final segment claims the full guest-committed output
                # (all assumptions); resolve strips them below
                output = session_segment_output(session)
                for i, seg in enumerate(session.segments):
                    final = i == len(session.segments) - 1
                    sc = segment_claim(seg, final, session_exit,
                                       output if final else None)
                    segment_claims[seg.index] = sc
                    # with an asset server, segments ship by digest
                    if self.asset_addr is not None:
                        from .assets import SegmentAssetRef
                        from ..zkvm.exec import resolve_segment
                        seg, self._asset_client = SegmentAssetRef.store(
                            resolve_segment(seg), self.asset_addr,
                            self._asset_client)
                    first = TaskKind.PREFLIGHT if self.split_preflight \
                        else TaskKind.PROVE_SEGMENT
                    self._submit(first, (seg, sc))
                    outstanding += 1
                for req in getattr(session, "pending_keccaks", []):
                    self._submit(TaskKind.PROVE_KECCAK, req)
                    outstanding += 1
            elif task.kind == TaskKind.PREFLIGHT:
                seg, sc = task.payload
                self._submit(TaskKind.PROVE_SEGMENT, (seg, sc, result))
                outstanding += 1
            elif task.kind == TaskKind.PROVE_SEGMENT:
                seg = task.payload[0]
                if self.receipt_kind == "composite":
                    # no recursion layer: chain the segment receipts as-is
                    segment_receipts[seg.index] = result
                    continue
                work = None
                if self.povw:
                    from ..zkvm.povw import Work
                    nonce = self.env.povw_job_id.nonce(seg.index)
                    work = Work(nonce, nonce, 1 << seg.po2)
                self._submit(TaskKind.LIFT, (seg.index, result, work))
                outstanding += 1
            elif task.kind == TaskKind.LIFT:
                idx, _, _work = task.payload
                lifted.append(_LiftedRange(idx, idx, result))
                try_join()
            elif task.kind == TaskKind.JOIN:
                a, b, _povw = task.payload
                lifted.append(_LiftedRange(a.lo, b.hi, result))
                try_join()
            elif task.kind == TaskKind.PROVE_KECCAK:
                # coprocessor receipts feed the union tree below
                keccak_receipts[task.task_id] = result
        self.coproc_receipts += [keccak_receipts[t]
                                 for t in self._keccak_tasks]
        if self.coproc_receipts:
            self.union_receipt = self._union_tree(chan, self.coproc_receipts)

        if self.receipt_kind == "composite":
            # reference prover_impl.rs composite flow: segment receipts in
            # index order + inline assumption receipts, no recursion layer
            from ..zkvm.receipt import CompositeReceipt
            assert len(segment_receipts) == len(session.segments)
            return session, CompositeReceipt(
                segments=[segment_receipts[k]
                          for k in sorted(segment_receipts)],
                assumption_receipts=[
                    r for r in map(self._assumption_receipt,
                                   getattr(session, "assumptions_used", []))
                    if hasattr(r, "verify_integrity")])

        assert len(lifted) == 1, f"join tree did not converge: {lifted}"
        root = lifted[0].receipt

        # resolve chain: strip each recorded assumption head-first
        # (reference job/proof.rs:363-399 resolve phase; sequential because
        # each resolve consumes the previous conditional receipt).  An
        # unresolved (receipt-less) assumption is the keccak batcher's
        # union-MMR root: resolve it with the union receipt proved above
        # (reference prover_impl.rs:121-139).
        for used in getattr(session, "assumptions_used", []):
            receipt = self._assumption_receipt(used)
            if receipt is None:
                continue
            self._submit(TaskKind.RESOLVE, (root, receipt, self.povw))
            root = self._wait(chan).result

        return session, self._finish(chan, root)

    def _assumption_receipt(self, used):
        """The receipt of one assumptions_used entry: its own, or for a
        receipt-less one (the keccak batcher's union-MMR root) the union
        receipt when it proves that claim, else None (left assumed)."""
        assum, receipt = used
        if receipt is None and self.union_receipt is not None and \
                np.array_equal(np.asarray(assum.claim, np.uint32),
                               _claim_digest(self.union_receipt)):
            return self.union_receipt
        return receipt

    def _wait(self, chan):
        done = chan.get()
        if done.error is not None:
            raise done.error
        return done

    def _union_tree(self, chan, items):
        """One union receipt of `items`, merged as
        MerkleMountainAccumulator merges them in this order: a perfect
        binary tree over each run of 2^k leaves, the largest first (their
        pairs proved concurrently, a level a round), then the peaks folded
        left to right."""
        trees, off = [], 0
        for bit in reversed(range(len(items).bit_length())):
            if len(items) >> bit & 1:
                trees.append(items[off : off + (1 << bit)])
                off += 1 << bit
        while any(len(t) > 1 for t in trees):
            slots = {}
            for ti, t in enumerate(trees):
                if len(t) > 1:
                    for i in range(0, len(t), 2):
                        slots[self._submit(TaskKind.UNION,
                                           (t[i], t[i + 1]))] = (ti, i // 2)
            nxt = [[None] * (len(t) // 2) if len(t) > 1 else t
                   for t in trees]
            for _ in range(len(slots)):
                done = self._wait(chan)
                ti, i = slots[done.task.task_id]
                nxt[ti][i] = done.result
            trees = nxt
        acc = trees[0][0]
        for t in trees[1:]:
            self._submit(TaskKind.UNION, (acc, t[0]))
            acc = self._wait(chan).result
        return acc

    def _finish(self, chan, root):
        # PoVW: expose the proven total work, then strip the WorkClaim
        # wrapper so the final receipt carries the bare session claim
        # (reference unwrap_povw / *_unwrap_povw variants)
        if self.povw:
            self.work = root.claim.work
            self._submit(TaskKind.UNWRAP, root)
            root = self._wait(chan).result

        # groth16: shrink-wrap the succinct receipt (reference
        # shrink_wrap: identity_p254, then the BN254 Groth16 prove)
        if self.receipt_kind == "groth16":
            self._submit(TaskKind.SHRINK_WRAP, root)
            root = self._wait(chan).result
        return root


def run_task(prover, task: Task):
    """Run one task with `prover` (execute needs none): the processor of
    every worker pool (reference actors/worker.rs:78-607)."""
    from ..zkvm.exec import ExecutorImpl, resolve_segment

    kind, payload = task.kind, task.payload
    if kind == TaskKind.EXECUTE:
        env, elf = payload
        return ExecutorImpl(env, elf).run()
    if kind == TaskKind.PREFLIGHT:
        seg, _claim = payload
        return prover.segment_preflight(seg)
    if kind == TaskKind.PROVE_SEGMENT:
        if len(payload) == 3:     # split-preflight core task
            seg, claim, preflight = payload
            return prover.prove_segment_core(preflight, seg, claim)
        seg, claim = payload
        return prover.prove_segment(resolve_segment(seg), claim)
    if kind == TaskKind.LIFT:
        _idx, segment_receipt, work = payload
        if work is not None:
            return prover.lift_povw(segment_receipt, work=work)
        return prover.lift(segment_receipt)
    if kind == TaskKind.JOIN:
        a, b, povw = payload
        if povw:
            return prover.join_povw(a.receipt, b.receipt)
        return prover.join(a.receipt, b.receipt)
    if kind == TaskKind.UNION:
        return prover.union(*payload)
    if kind == TaskKind.PROVE_KECCAK:
        return prover.prove_keccak(payload)
    if kind == TaskKind.RESOLVE:
        conditional, assumption, povw = payload
        if povw:
            return prover.resolve_povw(conditional, assumption)
        return prover.resolve(conditional, assumption)
    if kind == TaskKind.UNWRAP:
        return prover.unwrap_povw(payload)
    if kind == TaskKind.SHRINK_WRAP:
        return prover.shrink_wrap(payload)
    raise RuntimeError(f"no processor for {kind}")


CPU_KINDS = [TaskKind.EXECUTE, TaskKind.PREFLIGHT]
ACCEL_KINDS = [TaskKind.PROVE_SEGMENT, TaskKind.PROVE_KECCAK, TaskKind.LIFT,
               TaskKind.JOIN, TaskKind.UNION, TaskKind.RESOLVE,
               TaskKind.UNWRAP, TaskKind.SHRINK_WRAP]


def make_local_pools(factory: Factory, prover=None, num_cpu: int = 2,
                     num_accel: int = 2, device="cuda") -> list[Worker]:
    """Default single-host topology (reference actors/mod.rs:185-240):
    CPU workers run execute and preflight, accelerator workers, threads
    sharing one card, run prove/lift/join.  `prover` serves the tasks;
    None: get_prover_server() on `device` (ProverImpl on the card, or the
    DevModeProver under RISC0_DEV_MODE)."""
    if prover is None:
        from ..zkvm.prover import get_prover_server

        prover = get_prover_server(device=device)

    def processor(task: Task):
        return run_task(prover, task)

    return ([Worker(factory, CPU_KINDS, processor, f"cpu-{i}").start()
             for i in range(num_cpu)]
            + [Worker(factory, ACCEL_KINDS, processor, f"accel-{i}").start()
               for i in range(num_accel)])
