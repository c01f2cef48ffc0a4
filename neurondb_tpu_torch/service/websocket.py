"""Minimal RFC 6455 WebSocket support for the agent server.

Reference: NeuronAgent's /ws endpoint (cmd/agent-server/main.go route,
gorilla/websocket) streaming agent messages. Stdlib-only implementation:
handshake (Sec-WebSocket-Accept), unfragmented text frames with client
masking, server frames unmasked, close handshake. Enough for the message
protocol: client sends {"session_id", "content"} JSON; the server replies
with {"type": "message", ...} frames and a final {"type": "done"}.

Counterpart of ``neurondb_tpu/service/websocket.py`` (stdlib only, the
same code); the runtime it serves is the port's ``AgentRuntime``.
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
from typing import Optional, Tuple

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# opcodes
OP_TEXT = 0x1
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

# A single frame header can claim a 64-bit payload length; cap it so one
# frame can't buffer gigabytes (close 1009 = message too big).
MAX_FRAME_BYTES = 1 << 20

CLOSE_PROTOCOL_ERROR = 1002
CLOSE_TOO_BIG = 1009


class WSProtocolError(ConnectionError):
    def __init__(self, msg: str, code: int = CLOSE_PROTOCOL_ERROR):
        super().__init__(msg)
        self.code = code


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(payload: bytes, opcode: int = OP_TEXT) -> bytes:
    """Server-to-client frame (FIN set, unmasked)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < (1 << 16):
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


def decode_frame(sock: socket.socket,
                 max_bytes: int = MAX_FRAME_BYTES,
                 require_mask: bool = True) -> Tuple[int, bytes]:
    """Read one frame -> (opcode, payload).

    RFC 6455 §5.1: client frames MUST be masked — an unmasked frame fails
    the connection (1002). Payloads above ``max_bytes`` are rejected
    (1009) before any buffering. A client reading server frames passes
    ``require_mask=False`` (server frames are unmasked)."""
    hdr = _read_exact(sock, 2)
    opcode = hdr[0] & 0x0F
    masked = bool(hdr[1] & 0x80)
    n = hdr[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", _read_exact(sock, 2))[0]
    elif n == 127:
        n = struct.unpack(">Q", _read_exact(sock, 8))[0]
    if n > max_bytes:
        raise WSProtocolError(f"frame of {n} bytes exceeds cap "
                              f"{max_bytes}", CLOSE_TOO_BIG)
    if not masked and require_mask:
        raise WSProtocolError("client frame not masked (RFC 6455 §5.1)")
    mask = _read_exact(sock, 4) if masked else b"\x00" * 4
    data = bytearray(_read_exact(sock, n))
    if masked:
        for i in range(n):
            data[i] ^= mask[i % 4]
    return opcode, bytes(data)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket peer closed")
        buf += chunk
    return buf


def handle_ws_upgrade(handler) -> Optional[socket.socket]:
    """Upgrade a BaseHTTPRequestHandler connection to a WebSocket.
    Returns the raw socket on success, None if not a WS request."""
    key = handler.headers.get("Sec-WebSocket-Key")
    if (handler.headers.get("Upgrade", "").lower() != "websocket"
            or key is None):
        return None
    resp = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n")
    handler.connection.sendall(resp.encode())
    return handler.connection


def serve_agent_ws(sock: socket.socket, runtime) -> None:
    """Message loop: {"session_id", "content"} in -> agent reply out."""
    try:
        while True:
            opcode, payload = decode_frame(sock)
            if opcode == OP_CLOSE:
                sock.sendall(encode_frame(payload, OP_CLOSE))
                return
            if opcode == OP_PING:
                sock.sendall(encode_frame(payload, OP_PONG))
                continue
            if opcode != OP_TEXT:
                continue
            try:
                req = json.loads(payload.decode())
                msg = runtime.execute(req["session_id"],
                                      req.get("content", ""))
                sock.sendall(encode_frame(json.dumps(
                    {"type": "message", "message_id": msg.message_id,
                     "role": msg.role, "content": msg.content,
                     "tool_calls": msg.tool_calls}).encode()))
                sock.sendall(encode_frame(
                    json.dumps({"type": "done"}).encode()))
            except (KeyError, json.JSONDecodeError) as e:
                sock.sendall(encode_frame(json.dumps(
                    {"type": "error", "error": str(e)}).encode()))
    except WSProtocolError as e:
        try:
            sock.sendall(encode_frame(
                struct.pack(">H", e.code) + str(e).encode()[:120],
                OP_CLOSE))
        except OSError:
            pass
        return
    except (ConnectionError, OSError):
        return
