"""The port's transports and manager FSMs (``fedml_tpu_torch/core/comm``
and ``core/managers.py``) through the reference's own scenarios
(``tests/test_comm_tcp.py``, ``test_managers.py``,
``test_tcp_fsm_round.py`` and ``test_comm_mqtt.py``, retargeted at the
port: the reference's inputs and asserts), and both packages over one
TCP star: a port ``ResilientFedAvgServer`` serving reference clients and
a reference server serving port clients, 3 rounds of
``quadratic_trainer``, each ``history`` bit-equal to the all-reference
run. Every socket test bounds itself through the transports' own
timeouts; nothing compared depends on the wall clock."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import socket
import threading
import types

import numpy as np

from reference_scenarios import retarget

_tcp = retarget("test_comm_tcp.py")
_managers = retarget("test_managers.py")
_fsm = retarget("test_tcp_fsm_round.py")
_mqtt = retarget("test_comm_mqtt.py")


def test_the_retargeted_scenarios_run_the_port():
    assert _tcp.TcpCommManager.__module__ == "fedml_tpu_torch.core.comm.tcp"
    assert _managers.ClientManager.__module__ == \
        "fedml_tpu_torch.core.managers"
    assert _fsm.params_to_lists.__module__ == "fedml_tpu_torch.core.message"
    assert _mqtt.MqttCommManager.__module__ == \
        "fedml_tpu_torch.core.comm.mqtt"

# core/comm/tcp.py: the star protocol, peer loss both ways, fail-fast,
# GOODBYE, client-initiated stop, the counters and the pipe-lock split
test_full_star_protocol = _tcp.test_full_star_protocol
test_client_death_surfaces_at_server = \
    _tcp.test_client_death_surfaces_at_server
test_server_death_surfaces_at_client = \
    _tcp.test_server_death_surfaces_at_client
test_manager_fsm_fails_fast_on_peer_loss = \
    _tcp.test_manager_fsm_fails_fast_on_peer_loss
test_clean_client_goodbye_is_not_a_crash = \
    _tcp.test_clean_client_goodbye_is_not_a_crash
test_client_initiated_stop_no_spurious_peer_lost = \
    _tcp.test_client_initiated_stop_no_spurious_peer_lost
TestConcurrencyFixes = _tcp.TestConcurrencyFixes

# core/managers.py: no-handler drops, peer-lost fail-fast, registration
TestNoHandlerPath = _managers.TestNoHandlerPath
TestPeerLostFailFast = _managers.TestPeerLostFailFast
TestRegistrationSemantics = _managers.TestRegistrationSemantics

# two FedAvg rounds of hand-written FSMs over TCP (the mobile codec)
test_two_round_fedavg_protocol_over_tcp = \
    _fsm.test_two_round_fedavg_protocol_over_tcp

# core/comm/mqtt.py on the injectable in-memory broker
test_topic_scheme_and_roundtrip = _mqtt.test_topic_scheme_and_roundtrip
test_mobile_codec_over_wire = _mqtt.test_mobile_codec_over_wire
test_observer_remove_and_stop = _mqtt.test_observer_remove_and_stop


# ---------------------------------------------------------------------------
# net/ingest.py: the decode stage keeps each peer's order
# ---------------------------------------------------------------------------
def _decode_stage_output(ingest):
    """Items of 3 peers (frames and an EOF each) through 2 decode
    workers, then a barrier: each peer's items in order, decoded."""
    import queue

    out = queue.SimpleQueue()
    stage = ingest.DecodeStage(2, lambda item: ("frame", item[1],
                                                item[2] * 10), out)
    for i in range(12):
        stage.submit(i % 3, ("frame", i % 3, i))
    for rank in range(3):
        stage.submit(rank, ("eof", rank))
    stage.post_barrier(("stopped",))
    items = [out.get(timeout=10.0) for _ in range(16)]
    stage.close()
    by_rank = {r: [it for it in items[:-1] if it[1] == r] for r in range(3)}
    return by_rank, items[-1], stage.stats()["frames"]


def test_decode_stage_keeps_each_peers_order_as_the_reference():
    import fedml_tpu.net.ingest as jingest

    import fedml_tpu_torch.net.ingest as ingest

    got, want = _decode_stage_output(ingest), _decode_stage_output(jingest)
    assert got == want
    assert got[0][0] == [("frame", 0, 0), ("frame", 0, 30), ("frame", 0, 60),
                         ("frame", 0, 90), ("eof", 0)]
    assert got[1:] == (("stopped",), 12)


# ---------------------------------------------------------------------------
# both packages over one star
# ---------------------------------------------------------------------------
W0 = {"w": np.zeros((2, 3), np.float32), "b": np.ones(4, np.float32)}
WORLD, ROUNDS = 4, 3


def _package(name):
    """The control-plane pieces of ``fedml_tpu`` or ``fedml_tpu_torch``."""
    import importlib
    tcp = importlib.import_module(f"{name}.core.comm.tcp")
    res = importlib.import_module(f"{name}.resilience")
    return types.SimpleNamespace(
        TcpCommManager=tcp.TcpCommManager, RoundPolicy=res.RoundPolicy,
        ResilientFedAvgServer=res.ResilientFedAvgServer,
        ResilientFedAvgClient=res.ResilientFedAvgClient,
        quadratic_trainer=res.quadratic_trainer,
        run_tcp_fedavg=res.run_tcp_fedavg)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mixed_run(server_pkg, client_pkg):
    """``run_tcp_fedavg``'s scenario with the server of one package and
    the clients of the other."""
    port = _free_port()

    def client(rank):
        comm = client_pkg.TcpCommManager("localhost", port, rank, WORLD,
                                          timeout=30.0)
        client_pkg.ResilientFedAvgClient(
            None, comm, rank, WORLD, client_pkg.quadratic_trainer()).run()

    threads = [threading.Thread(target=client, args=(r,), daemon=True)
               for r in range(1, WORLD)]
    for t in threads:
        t.start()
    comm = server_pkg.TcpCommManager("localhost", port, 0, WORLD,
                                     timeout=30.0)
    server = server_pkg.ResilientFedAvgServer(
        None, comm, WORLD, W0, ROUNDS, server_pkg.RoundPolicy())
    server.register_message_receive_handlers()
    server.start()
    loop = threading.Thread(target=comm.handle_receive_message, daemon=True)
    loop.start()
    loop.join(timeout=60.0)
    assert not loop.is_alive(), "server hung"
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    return server


def _assert_same_history(got, want):
    assert got.failed is None and want.failed is None
    assert len(got.history) == len(want.history) == ROUNDS
    assert got.reporting_log == want.reporting_log
    for g, w in zip(got.history, want.history):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_port_server_serves_reference_clients():
    ref = _package("fedml_tpu")
    want = ref.run_tcp_fedavg(WORLD, ROUNDS, ref.RoundPolicy(), W0,
                              timeout=30.0, join_timeout=60.0)
    _assert_same_history(_mixed_run(_package("fedml_tpu_torch"), ref), want)


def test_reference_server_serves_port_clients():
    ref = _package("fedml_tpu")
    want = ref.run_tcp_fedavg(WORLD, ROUNDS, ref.RoundPolicy(), W0,
                              timeout=30.0, join_timeout=60.0)
    _assert_same_history(_mixed_run(ref, _package("fedml_tpu_torch")), want)
