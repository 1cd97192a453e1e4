"""libp2p transport security + stream multiplexing on the real wire format.

Equivalent of the reference's connection upgrade stack
(``lighthouse_network``'s libp2p transport: ``noise`` then ``yamux`` —
service/mod.rs builds exactly this ladder): TCP connections are secured
with the Noise XX handshake (Noise_XX_25519_ChaChaPoly_SHA256, the
libp2p-noise spec, carrying a secp256k1 libp2p identity proof in the
handshake payload) and then multiplexed with yamux framing.

Modules:
- ``x25519``     — RFC 7748 curve25519 (pinned to the RFC's test vectors)
- ``protocol``   — the Noise protocol core (CipherState/SymmetricState/XX)
- ``secure``     — libp2p-noise over a socket: identity payloads, length-
                   prefixed encrypted frames
- ``yamux``      — the yamux multiplexer (SYN/ACK/FIN/RST, windows, ping)
- ``multistream``— multistream-select 1.0: the upgrade ladder entry points
                   (``upgrade_outbound``/``upgrade_inbound``) and per-stream
                   protocol negotiation

A copy of the JAX package's ``lighthouse_tpu/network/noise/__init__.py``.
"""

from .multistream import upgrade_inbound, upgrade_outbound
from .secure import NoiseConnection, secure_accept, secure_dial
from .yamux import YamuxSession

__all__ = ["NoiseConnection", "secure_accept", "secure_dial",
           "YamuxSession", "upgrade_inbound", "upgrade_outbound"]
