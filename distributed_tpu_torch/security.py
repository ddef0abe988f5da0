"""TLS security configuration (reference distributed/security.py:57).

Builds ``ssl.SSLContext`` objects for listeners and connectors from the
``comm.tls`` config subtree or explicit kwargs; ``Security.temporary()``
generates a throwaway self-signed CA + keypair in memory for tests and
one-off clusters (reference security.py temporary credentials).
"""

from __future__ import annotations

import ssl
from typing import Any

from distributed_tpu_torch import config

_ROLES = ("scheduler", "worker", "client")


class Security:
    __slots__ = (
        "require_encryption",
        "tls_ca_file",
        "tls_ciphers",
        "tls_min_version",
        "tls_scheduler_cert",
        "tls_scheduler_key",
        "tls_worker_cert",
        "tls_worker_key",
        "tls_client_cert",
        "tls_client_key",
        "extra_conn_args",
    )

    def __init__(self, require_encryption: bool | None = None, **kwargs: Any):
        if require_encryption is None:
            require_encryption = bool(config.get("comm.require-encryption") or False)
        self.require_encryption = require_encryption

        def opt(name: str, config_key: str):
            # None (absent OR passed explicitly, e.g. an unset CLI flag)
            # always falls back to config — a present-but-None kwarg must
            # not mask a configured credential
            v = kwargs.get(name)
            return v if v is not None else config.get(config_key)

        self.tls_ca_file = opt("tls_ca_file", "comm.tls.ca-file")
        self.tls_ciphers = opt("tls_ciphers", "comm.tls.ciphers")
        self.tls_min_version = opt("tls_min_version", "comm.tls.min-version")
        for role in _ROLES:
            for kind in ("cert", "key"):
                attr = f"tls_{role}_{kind}"
                setattr(self, attr, opt(attr, f"comm.tls.{role}.{kind}"))
        self.extra_conn_args = kwargs.get("extra_conn_args") or {}

    # ------------------------------------------------------------------

    @classmethod
    def temporary(cls) -> "Security":
        """Self-signed in-memory credentials for throwaway clusters."""
        try:
            from cryptography import x509
            from cryptography.hazmat.primitives import hashes, serialization
            from cryptography.hazmat.primitives.asymmetric import rsa
            from cryptography.x509.oid import NameOID
        except ImportError as e:  # pragma: no cover
            raise ImportError("Security.temporary() requires `cryptography`") from e
        import datetime
        import tempfile

        key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
        subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "distributed-tpu")])
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (
            x509.CertificateBuilder()
            .subject_name(subject)
            .issuer_name(subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=7))
            .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
            .sign(key, hashes.SHA256())
        )
        cert_pem = cert.public_bytes(serialization.Encoding.PEM)
        key_pem = key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        )
        # ssl needs files; write once to a secure tempdir kept alive by the object
        d = tempfile.mkdtemp(prefix="dtpu-tls-")
        cert_path = f"{d}/cert.pem"
        key_path = f"{d}/key.pem"
        with open(cert_path, "wb") as f:
            f.write(cert_pem)
        with open(key_path, "wb") as f:
            f.write(key_pem)
        kwargs: dict[str, Any] = {"tls_ca_file": cert_path}
        for role in _ROLES:
            kwargs[f"tls_{role}_cert"] = cert_path
            kwargs[f"tls_{role}_key"] = key_path
        return cls(require_encryption=True, **kwargs)

    # ------------------------------------------------------------------

    def _ctx(self, role: str, server: bool) -> ssl.SSLContext | None:
        cert = getattr(self, f"tls_{role}_cert")
        key = getattr(self, f"tls_{role}_key")
        if not cert:
            return None
        ctx = ssl.SSLContext(
            ssl.PROTOCOL_TLS_SERVER if server else ssl.PROTOCOL_TLS_CLIENT
        )
        if self.tls_min_version == 1.3:
            ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        else:
            ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        if self.tls_ca_file:
            ctx.load_verify_locations(self.tls_ca_file)
        ctx.load_cert_chain(cert, key or None)
        # mutual auth, no hostname checks (certs identify roles, not hosts)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_REQUIRED
        if self.tls_ciphers:
            ctx.set_ciphers(self.tls_ciphers)
        return ctx

    def get_listen_args(self, role: str) -> dict:
        return {"ssl_context": self._ctx(role, server=True)}

    def get_connection_args(self, role: str) -> dict:
        return {"ssl_context": self._ctx(role, server=False)}

    def __repr__(self) -> str:
        on = bool(self.tls_scheduler_cert or self.tls_client_cert)
        return f"Security(tls={'on' if on else 'off'}, require_encryption={self.require_encryption})"
