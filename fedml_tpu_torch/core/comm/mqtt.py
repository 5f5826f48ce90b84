"""MQTT device bridge (optional transport for on-device / mobile clients;
counterpart of ``fedml_tpu/core/comm/mqtt.py``).

Topic scheme parity with reference ``fedml_core/distributed/communication/
mqtt/mqtt_comm_manager.py:47-120``: the server (client_id 0) publishes to
``<prefix>0_<clientID>`` and subscribes to ``<prefix><clientID>``; clients
mirror-image. Payload defaults to the binary envelope ``Message.to_bytes()``
(``fedml_tpu_torch.compression.codec``: JSON control header + raw-byte array
frames -- MQTT payloads are bytes, brokers don't care). Back-compat is
*inbound*: frames are sniffed, so legacy ``Message.to_json()`` senders keep
working against this manager -- but legacy-only RECEIVERS cannot parse the
binary envelope, so a fleet with un-upgraded subscribers must pass
``binary=False`` to publish the legacy JSON (ndarray->list) codec.

``paho-mqtt`` is optional and imported only when a manager is built
without an injected client; the class raises a clear error at
construction when it is unavailable. No broker address is hardcoded
(the reference shipped one in-tree -- a noted defect,
``client_manager.py:22``).

For tests (no broker in the image) the constructor accepts a
``client_factory`` returning any paho-compatible client object (``connect``,
``subscribe``, ``publish``, ``loop_forever``, ``loop_stop``, ``disconnect``,
``on_connect``/``on_message`` attributes) -- see
``tests/test_torch_comm.py``'s in-memory broker.
"""

from __future__ import annotations

from fedml_tpu_torch.core.comm.base import BaseCommunicationManager
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.observability.flightrec import get_flight_recorder
from fedml_tpu_torch.observability.registry import get_registry


def _paho_factory(client_id: str):  # pragma: no cover - needs paho
    import paho.mqtt.client as mqtt
    try:  # paho-mqtt >= 2.0 requires an explicit callback API version
        return mqtt.Client(mqtt.CallbackAPIVersion.VERSION1,
                           client_id=client_id)
    except AttributeError:  # paho-mqtt 1.x
        return mqtt.Client(client_id=client_id)


class MqttCommManager(BaseCommunicationManager):
    def __init__(self, host, port, topic_prefix="fedml", client_id=0,
                 client_num=0, client_factory=None, binary=True):
        self._binary = bool(binary)
        self.bytes_sent = 0
        self.bytes_received = 0
        self.resends = 0  # frames re-sent by the retry layer
        if client_factory is None:
            try:
                import paho.mqtt.client  # noqa: F401
            except ImportError:
                raise RuntimeError(
                    "paho-mqtt is not installed; the MQTT bridge is optional. "
                    "Use the 'local' transport for simulation.") from None
            client_factory = _paho_factory
        self._topic = topic_prefix
        self.client_id = client_id
        self.client_num = client_num
        self._observers = []
        self._client = client_factory(str(client_id))
        self._client.on_connect = self._on_connect
        self._client.on_message = self._on_message
        self._client.connect(host, port)

    def _on_connect(self, client, userdata, flags, rc):
        if self.client_id == 0:  # server subscribes to every client's uplink
            for cid in range(1, self.client_num + 1):
                client.subscribe(self._topic + str(cid))
        else:  # client subscribes to its downlink
            client.subscribe(self._topic + "0_" + str(self.client_id))

    def _on_message(self, client, userdata, msg):
        payload = msg.payload
        if isinstance(payload, str):  # permissive fakes publish str
            payload = payload.encode("utf-8")
        self.bytes_received += len(payload)
        m = Message.from_bytes(payload)  # binary or legacy-JSON sniff
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("recv", type=m.get_type(), src=m.get_sender_id(),
                      dst=self.client_id, bytes=len(payload),
                      transport="mqtt")
        reg = get_registry()
        if reg is not None:
            reg.inc("comm_bytes_total", len(payload),
                    help="control-plane payload bytes by direction",
                    transport="mqtt", direction="received")
        for obs in self._observers:
            obs.receive_message(m.get_type(), m)

    def send_message(self, msg: Message, is_resend=False):
        receiver = msg.get_receiver_id()
        if self.client_id == 0:
            topic = self._topic + "0_" + str(receiver)
        else:
            topic = self._topic + str(self.client_id)
        payload = msg.to_bytes() if self._binary else msg.to_json()
        self.bytes_sent += len(payload)
        if is_resend:
            self.resends += 1
        fr = get_flight_recorder()
        if fr is not None:
            fr.record("send", type=msg.get_type(), src=self.client_id,
                      dst=receiver, bytes=len(payload), transport="mqtt",
                      resend=bool(is_resend))
        reg = get_registry()
        if reg is not None:
            reg.inc("comm_bytes_total", len(payload),
                    help="control-plane payload bytes by direction",
                    transport="mqtt", direction="sent")
            if is_resend:
                reg.inc("comm_resends_total",
                        help="frames re-sent by the retry layer",
                        transport="mqtt")
        self._client.publish(topic, payload=payload)

    def add_observer(self, observer):
        self._observers.append(observer)

    def remove_observer(self, observer):
        self._observers.remove(observer)

    def handle_receive_message(self):
        self._client.loop_forever()

    def stop_receive_message(self):
        self._client.loop_stop()
        self._client.disconnect()

    def abort(self):
        """Crash simulation (``fedml_tpu_torch.resilience``): kill the broker
        connection WITHOUT a DISCONNECT packet, so the broker's last-will
        / keepalive-timeout machinery fires -- what peers would see on a
        real device power-off. ``disconnect()`` would be a clean hang-up
        (the broker discards the last-will), defeating the simulation;
        close the raw socket instead when the client exposes it (paho
        does); permissive test fakes without a socket fall back to a
        plain stop."""
        self._client.loop_stop()
        sock = getattr(self._client, "socket", lambda: None)()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        else:  # fake client without a transport: best-effort teardown
            self._client.disconnect()
