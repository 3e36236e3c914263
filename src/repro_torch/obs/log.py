"""The ``repro_torch.*`` logger hierarchy.

Production embedders capture pipeline warnings (validation repairs,
degradation fallbacks) by attaching a handler to the ``"repro_torch"``
logger or any child (``repro_torch.validate``,
``repro_torch.degradation``) — no scraping ``RuntimeWarning`` out of the
warnings filter.  The ``warnings.warn`` calls are kept alongside (tests
and notebooks rely on them); the logger is the structured, filterable
channel.

``REPRO_LOG`` configures console output without touching code:

* ``REPRO_LOG=info`` — stderr handler on ``repro_torch`` at INFO
* ``REPRO_LOG=repro_torch.validate=debug,repro_torch=warning`` —
  per-logger levels (a stderr handler is installed on ``repro_torch``)

Unset (the default), the hierarchy stays silent: a ``NullHandler`` on
the ``repro_torch`` root stops the stdlib's last-resort stderr handler
from double-printing every warning-level record.
"""
from __future__ import annotations

import logging
import os
import threading

__all__ = ["get_logger"]

_ROOT = "repro_torch"
_configured = False
_config_lock = threading.Lock()


def _parse_spec(spec: str) -> list[tuple[str, int]]:
    """``"info"`` -> [("repro_torch", INFO)];
    ``"repro_torch.validate=debug,..."`` -> one (logger, level) per
    comma-separated entry.  Unknown level names are ignored (a bad env
    var must never crash a build)."""
    out: list[tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, level_name = part.rpartition("=")
        name = name or _ROOT
        level = logging.getLevelName(level_name.strip().upper())
        if isinstance(level, int):
            out.append((name if name.startswith(_ROOT) else
                        f"{_ROOT}.{name}", level))
    return out


def _configure_once() -> None:
    global _configured
    if _configured:
        return
    with _config_lock:
        if _configured:
            return
        root = logging.getLogger(_ROOT)
        root.addHandler(logging.NullHandler())
        spec = os.environ.get("REPRO_LOG", "")
        levels = _parse_spec(spec) if spec else []
        if levels:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"))
            root.addHandler(handler)
            for name, level in levels:
                logging.getLogger(name).setLevel(level)
        _configured = True


def get_logger(name: str = _ROOT) -> logging.Logger:
    """A logger under the ``repro_torch`` hierarchy (prefix added when
    missing), with the one-time ``REPRO_LOG`` configuration applied."""
    _configure_once()
    if not (name == _ROOT or name.startswith(_ROOT + ".")):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
