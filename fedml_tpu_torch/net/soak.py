"""Many-connection soak harness: N protocol-complete clients, two loops
(counterpart of ``fedml_tpu/net/soak.py``; ``python -m
fedml_tpu_torch.net.soak --swarm ...`` is the swarm's process).

A 10k-connection soak cannot spend a thread (or an FSM object) per
client: the *swarm* half of this module drives every client from ONE
selector loop in a subprocess -- each swarm client dials, HELLOs, and
then answers every ``res_sync`` with a real ``res_report`` (the
quadratic-trainer gradient step over the synced params, numpy
arithmetic, seeded per-client reply jitter so the report-latency
histogram grows a genuine tail). The parent half (:func:`run_soak`)
runs the REAL server stack against it: an
:class:`~fedml_tpu_torch.resilience.async_agg.AsyncBufferedFedAvgServer`
over the :class:`~fedml_tpu_torch.net.eventloop.EventLoopCommManager`,
with the
perf monitor armed -- so the soak's evidence is exactly production's:
``status.json`` health snapshots and the
``fed_report_latency_seconds`` histogram tails.

Two processes because of file descriptors: N connections cost N fds on
each side, and one process paying both halves would hit the fd ceiling
at half the connection count the host can actually serve.

The swarm computes with numpy and the wire codec only, and places
nothing on a device: it proves the *control plane*, not the math.
"""

from __future__ import annotations

import argparse
import json
import logging
import selectors
import socket
import struct
import subprocess
import sys
import time
from collections import deque

import numpy as np

_HDR = struct.Struct("!I")


class _SwarmClient:
    """One multiplexed soak client: rx framing state + tx queue."""

    __slots__ = ("sock", "rank", "gid", "tx", "rx_hdr", "rx_buf",
                 "rx_view", "rx_got", "reports", "want_write", "due",
                 "residual")

    def __init__(self, sock, rank, gid=None):
        self.sock = sock
        self.rank = rank
        self.gid = rank if gid is None else gid
        self.tx = deque()
        self.rx_hdr = memoryview(bytearray(_HDR.size))
        self.rx_buf = None
        self.rx_view = None
        self.rx_got = 0
        self.reports = 0
        self.want_write = False
        self.due = None  # (send_at_monotonic, frame_views) jittered reply
        self.residual = None  # per-client EF accumulator (wire compression)


def _quadratic_step(params, rank, lr=0.25):
    """The quadratic-trainer oracle (resilience.integration), inlined so
    the swarm stays numpy-only: one GD step on
    ``0.5 * ||w - rank||^2`` + the rank-keyed sample count."""
    out = {}
    for k in sorted(params):
        w = np.asarray(params[k], np.float32)
        target = np.full_like(w, np.float32(rank))
        out[k] = w + np.float32(lr) * (target - w)
    return out, float(10 * rank)


def run_swarm(host, port, clients, world_size, rank_base=1, jitter_s=0.0,
              seed=0, connect_timeout=120.0, idle_timeout=600.0,
              trace_path=None, compressor=None, gid_base=None,
              gid_stride=1):
    """Drive ``clients`` soak clients over one selector loop until the
    server stops or disconnects every one of them. Returns a summary
    dict (connections made, reports sent, wall seconds).

    ``trace_path`` replays a :class:`~fedml_tpu_torch.resilience.faults.
    DiurnalTrace` JSON file as the reply model instead of the uniform
    ``jitter_s``: each reply is delayed by the phase active at
    trace-relative now (day/night arrival swings, outage latency,
    flash crowds) and phase-dark ranks (correlated dropouts) send no
    reply at all -- the same seeded format the pace-steering bench and
    the distributed drivers consume, so the soak's latency histogram
    carries a realistic arrival curve.

    ``compressor`` (spec string, e.g. ``"qsgd"``) makes every swarm
    client ship compressed update deltas (``cdelta`` +
    ``compressor`` report keys) through the same numpy-only
    :mod:`fedml_tpu_torch.compression.wire` path the real client FSM
    uses, and the async server folds the deltas
    sparsely against each report's base version.

    ``gid_base``/``gid_stride`` shard one logical swarm across edge
    processes of a federation tree: client ``i`` dials with LOCAL rank
    ``rank_base + i`` (the leaf-star HELLO its edge expects) but keys
    its oracle step, EF rng, and trace decisions by GLOBAL id
    ``gid_base + i * gid_stride`` -- exactly the arithmetic slice
    nested :func:`~fedml_tpu_torch.net.fanin.round_robin_groups` assigns a
    bottom edge, so a sharded tree run folds bitwise against the
    single-tier host replication over the flat population. Default
    (``gid_base=None``) keys by the transport rank, today's behavior."""
    from fedml_tpu_torch.compression.codec import (message_from_wire,
                                                   message_to_wire_views)
    from fedml_tpu_torch.compression.wire import (ef_step, encode_rng,
                                                  host_compressor)
    from fedml_tpu_torch.core.message import Message

    comp = host_compressor(compressor)
    gen = None
    if trace_path:
        from fedml_tpu_torch.resilience.faults import (DiurnalTrace,
                                                       TraceLoadGen)
        gen = TraceLoadGen(DiurnalTrace.from_file(trace_path), seed=seed)
    sel = selectors.DefaultSelector()
    rng = np.random.default_rng(seed)
    dropped = 0
    conns = {}
    t_start = time.monotonic()
    deadline = t_start + connect_timeout
    for i in range(clients):
        rank = rank_base + i
        while True:  # backlog overflow under a dial burst: retry
            try:
                sock = socket.create_connection((host, port), timeout=30.0)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        hello = json.dumps({"rank": rank}).encode()
        sock.sendall(_HDR.pack(len(hello)) + hello)
        sock.setblocking(False)
        gid = None if gid_base is None else gid_base + i * gid_stride
        c = _SwarmClient(sock, rank, gid=gid)
        conns[rank] = c
        sel.register(sock, selectors.EVENT_READ, c)
    connected = len(conns)
    logging.info("swarm: %d connections up in %.2fs", connected,
                 time.monotonic() - t_start)
    reports = 0
    stop_at = time.monotonic() + idle_timeout

    def close(c):
        try:
            sel.unregister(c.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            c.sock.close()
        except OSError:
            pass
        conns.pop(c.rank, None)

    def flush(c):
        while c.tx:
            buf = c.tx[0]
            try:
                n = c.sock.send(buf)
            except (BlockingIOError, InterruptedError):
                if not c.want_write:
                    c.want_write = True
                    sel.modify(c.sock, selectors.EVENT_READ
                               | selectors.EVENT_WRITE, c)
                return
            except OSError:
                close(c)
                return
            if n == len(buf):
                c.tx.popleft()
            else:
                c.tx[0] = buf[n:]
        if c.want_write:
            c.want_write = False
            try:
                sel.modify(c.sock, selectors.EVENT_READ, c)
            except (KeyError, ValueError, OSError):
                pass

    def on_frame(c, frame):
        nonlocal reports, dropped
        msg = message_from_wire(frame)
        mtype = msg.get_type()
        if mtype == "__stop__":
            close(c)
            return
        if mtype != "res_sync":
            return  # reserved frames: nothing for a soak client to do
        delay = None
        if gen is not None:
            # diurnal-trace reply model: phase-dark ranks stay silent
            # (correlated dropout), everyone else replies at the phase's
            # seeded delay -- the realistic arrival curve. Trace time is
            # the generator's LAZY epoch (t=0 at the first reply), so the
            # connect burst of a big swarm cannot eat the first phases
            action = gen.decide(c.gid, c.reports, gen.trace_time())
            if action[0] == "drop":
                dropped += 1
                return
            delay = action[1]
        base = msg.get("params")
        params, n = _quadratic_step(base, c.gid)
        version = int(msg.get("round"))
        out = Message("res_report", c.rank, 0)
        if comp is None:
            out.add("params", params)
        else:
            # wire compression: ship the compressed update DELTA
            # (numpy-only ef_step; EF residual only for the biased
            # compressors); the rng
            # is keyed (rank, version, report-ordinal) so reruns encode
            # deterministically
            delta = {k: np.asarray(params[k], np.float32)
                     - np.asarray(base[k], np.float32) for k in params}
            enc, _dec, c.residual = ef_step(
                comp, delta, c.residual,
                encode_rng((c.gid, version, c.reports)))
            out.add("cdelta", enc)
            out.add("compressor", comp.spec)
        out.add("num_samples", n)
        out.add("round", version)
        out.add("attempt", int(msg.get("attempt")))
        views = [memoryview(v) if not isinstance(v, memoryview) else v
                 for v in message_to_wire_views(out)]
        nbytes = sum(len(v) for v in views)
        frame_views = [memoryview(_HDR.pack(nbytes))] + views
        c.reports += 1
        reports += 1
        if delay is None and jitter_s > 0:
            # seeded uniform reply jitter (the pre-trace model)
            delay = float(rng.random()) * jitter_s
        if delay:
            c.due = (time.monotonic() + delay, frame_views)
        else:
            c.tx.extend(frame_views)
            flush(c)

    def on_readable(c):
        while True:
            try:
                if c.rx_buf is None:
                    n = c.sock.recv_into(c.rx_hdr[c.rx_got:])
                else:
                    n = c.sock.recv_into(c.rx_view[c.rx_got:])
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                close(c)
                return
            if n == 0:
                close(c)
                return
            c.rx_got += n
            if c.rx_buf is None:
                if c.rx_got < _HDR.size:
                    continue
                (length,) = _HDR.unpack(c.rx_hdr)
                c.rx_buf = bytearray(length)
                c.rx_view = memoryview(c.rx_buf)
                c.rx_got = 0
            if c.rx_buf is not None and c.rx_got == len(c.rx_buf):
                frame, c.rx_buf, c.rx_view, c.rx_got = (c.rx_buf, None,
                                                        None, 0)
                on_frame(c, frame)
                if c.rank not in conns:
                    return  # closed by the frame handler

    while conns and time.monotonic() < stop_at:
        for key, mask in sel.select(0.1):
            c = key.data
            if mask & selectors.EVENT_READ:
                on_readable(c)
            if mask & selectors.EVENT_WRITE and c.rank in conns:
                flush(c)
        if jitter_s > 0 or gen is not None:
            now = time.monotonic()
            for c in list(conns.values()):
                if c.due is not None and now >= c.due[0]:
                    c.tx.extend(c.due[1])
                    c.due = None
                    flush(c)
    sel.close()
    return {"connections": connected, "reports": reports,
            "dropped": dropped, "unfinished": len(conns),
            "trace": bool(gen is not None),
            "compressor": comp.spec if comp is not None else None,
            "wall_s": round(time.monotonic() - t_start, 3)}


def run_soak(n_clients, total_updates=3, host="localhost", port=None,
             buffer_k=None, flush_deadline_s=30.0, jitter_s=0.5,
             high_watermark=32 * 2 ** 20, join_timeout=600.0,
             handshake_timeout=None, init_params=None,
             metrics_logger=None, trace_path=None, pace_controller=None,
             decode_workers=1, compressor=None):
    """The soak scenario: a real buffered-async server over the event
    loop, ``n_clients`` swarm connections from a subprocess. Arm
    ``observability.enable(perfmon=True, status_path=...)`` around this
    call to get the ``status.json`` + latency-histogram evidence.
    ``trace_path`` makes the swarm replay a DiurnalTrace JSON file
    instead of uniform jitter (see :func:`run_swarm`);
    ``pace_controller`` arms closed-loop pace steering on the server;
    ``decode_workers`` sizes the server transport's parallel frame-
    decode stage (1 = today's inline dispatcher decode -- trajectories
    are identical at any setting, only decode throughput moves);
    ``compressor`` (e.g. ``"qsgd"``) makes the swarm ship compressed
    report deltas that the server folds sparsely (see
    :func:`run_swarm` -- reports/sec and bytes-per-report move, the
    protocol does not). Returns ``(server, swarm_summary_dict)``."""
    import socket as _socket

    from fedml_tpu_torch.net.eventloop import EventLoopCommManager
    from fedml_tpu_torch.program.aggregation import AggregationPolicy
    from fedml_tpu_torch.resilience.async_agg import (
        AsyncBufferedFedAvgServer)
    if port is None:
        s = _socket.socket()
        s.bind((host, 0))
        port = s.getsockname()[1]
        s.close()
    if init_params is None:
        init_params = {"w": np.zeros(8, np.float32),
                       "b": np.ones(4, np.float32)}
    world = n_clients + 1
    policy = AggregationPolicy(
        buffer_k=buffer_k if buffer_k is not None else n_clients,
        staleness_decay=0.5, flush_deadline_s=float(flush_deadline_s))
    # the swarm dials with retry, so spawn it first and let the server's
    # listener come up under the burst
    cmd = [sys.executable, "-m", "fedml_tpu_torch.net.soak", "--swarm",
           "--host", host, "--port", str(port), "--clients", str(n_clients),
           "--world", str(world), "--jitter_s", str(jitter_s)]
    if trace_path:
        cmd += ["--trace", str(trace_path)]
    if compressor:
        cmd += ["--compressor", str(compressor)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        comm = EventLoopCommManager(
            host, port, 0, world,
            timeout=handshake_timeout or max(120.0, n_clients / 50.0),
            metrics_logger=metrics_logger, high_watermark=high_watermark,
            low_watermark=high_watermark // 4,
            decode_workers=decode_workers)
        server = AsyncBufferedFedAvgServer(
            None, comm, world, init_params, total_updates, policy,
            metrics_logger=metrics_logger, pace_controller=pace_controller)
        server.register_message_receive_handlers()
        server.start()
        import threading
        loop = threading.Thread(target=comm.handle_receive_message,
                                daemon=True, name="soak-server-loop")
        loop.start()
        loop.join(timeout=join_timeout)
        if loop.is_alive():
            comm.stop_receive_message()
            loop.join(timeout=15.0)
            raise TimeoutError(
                f"soak server hung past {join_timeout}s (update "
                f"{server.agg.version}/{total_updates}, "
                f"failed={server.failed})")
        out, _ = proc.communicate(timeout=60.0)
    finally:
        if proc.poll() is None:
            proc.kill()
    summary = {}
    for line in (out or "").strip().splitlines():
        try:
            summary = json.loads(line)
        except json.JSONDecodeError:
            continue
    return server, summary


def _main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--swarm", action="store_true",
                   help="run the client swarm (the subprocess half)")
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--clients", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--jitter_s", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", type=str, default=None,
                   help="DiurnalTrace JSON file: replay its arrival "
                        "curve (per-phase reply delays + correlated "
                        "dropouts) instead of uniform --jitter_s")
    p.add_argument("--compressor", type=str, default=None,
                   help="wire-compression spec (qsgd/topk:R/signsgd): "
                        "ship compressed report deltas instead of "
                        "full params (compression.wire, numpy-only)")
    p.add_argument("--rank_base", type=int, default=1,
                   help="first LOCAL transport rank this shard dials "
                        "with (an edge's leaf star expects 1..L)")
    p.add_argument("--gid_base", type=int, default=None,
                   help="first GLOBAL leaf id of this shard (tree "
                        "sharding: keys the oracle/EF-rng/trace while "
                        "the transport rank stays local)")
    p.add_argument("--gid_stride", type=int, default=1,
                   help="GLOBAL id stride between this shard's "
                        "consecutive clients (the round-robin slice "
                        "stride = the product of the tree's fan-outs)")
    args = p.parse_args(argv)
    if not args.swarm:
        p.error("only the --swarm role has a CLI; run_soak is the "
                "parent-side API")
    logging.basicConfig(level=logging.INFO)
    summary = run_swarm(args.host, args.port, args.clients, args.world,
                        rank_base=args.rank_base, jitter_s=args.jitter_s,
                        seed=args.seed, trace_path=args.trace,
                        compressor=args.compressor,
                        gid_base=args.gid_base,
                        gid_stride=args.gid_stride)
    sys.stdout.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(_main())


__all__ = ["run_swarm", "run_soak"]
