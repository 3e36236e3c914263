"""Pytree checkpointing: msgpack (+ zstd where ``zstandard`` imports),
atomic commit, keep-k GC, async writes and elastic restore (the JAX
package's ``checkpoint/checkpoint.py``).

Layout, as the reference's:
  <dir>/step_000123.tmp/   (staging)
  <dir>/step_000123/
      leaves.msgpack.zst   {path: {shape, dtype, data}}
      MANIFEST.json        {step, format_version, axes, extra}  <- last

Leaves are tensors (any device) or numpy arrays; paths are those of the
reference's ``_flatten``; ``dtype`` is the numpy name.  bfloat16 is
written as its raw bytes under ``"bfloat16"`` and read back through an
int16 view, so ``ml_dtypes`` is not needed.

One deviation, the rule of the reference's own ``core/planio.py``: the
leaves file is a zstd frame when ``zstandard`` imports and raw msgpack
otherwise (the reference requires ``zstandard``).  :func:`restore` tells
the two apart by the zstd magic and raises, naming the package, on a zstd
file where ``zstandard`` is missing.  ``msgpack`` is required.

The training loop saves the parameters and the AdamW state in the
reference's stacked structure (:func:`repro_torch.models.params.
stack_tree`), the layers stacked on the host
(:func:`repro_torch.convert.host_stacked`), so the files hold what the
reference's hold.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

try:                                    # optional: smaller files when present
    import zstandard as _zstd
except ImportError:                     # pragma: no cover - env dependent
    _zstd = None

FORMAT_VERSION = 1
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _msgpack():
    try:
        import msgpack
    except ImportError as e:            # pragma: no cover - env dependent
        raise RuntimeError("checkpointing requires the optional 'msgpack' "
                           "package (pip install msgpack)") from e
    return msgpack


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict, skeleton):
    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(tree[k], f"{prefix}/{k}") for k in tree}
        if isinstance(tree, (list, tuple)):
            t = [build(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
            return type(tree)(t)
        return flat[prefix]
    return build(skeleton)


def _record(leaf) -> dict:
    """A leaf's shape, numpy dtype name and bytes (a host copy)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"shape": list(t.shape), "dtype": "bfloat16",
                    "data": t.view(torch.int16).numpy().tobytes()}
        leaf = t.numpy()
    a = np.asarray(leaf)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "data": a.tobytes()}      # C order, whatever the strides


def _tensor(rec) -> torch.Tensor:
    if rec["dtype"] == "bfloat16":
        a = np.frombuffer(rec["data"], dtype=np.int16).reshape(rec["shape"])
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    a = np.frombuffer(rec["data"], dtype=rec["dtype"]).reshape(rec["shape"])
    return torch.from_numpy(a.copy())


def save(ckpt_dir: str, step: int, tree, axes_tree=None, extra: dict | None
         = None, keep: int = 3, block: bool = True):
    """Atomic checkpoint write.  Every leaf is copied to the host before
    anything else, so ``block=False`` (a daemon thread writes; its
    ``Thread`` is returned) lets training overwrite its tensors in place
    at once."""
    msgpack = _msgpack()
    payload = {k: _record(v) for k, v in _flatten(tree).items()}

    def _write():
        tag = f"step_{step:08d}"
        tmp = os.path.join(ckpt_dir, tag + ".tmp")
        final = os.path.join(ckpt_dir, tag)
        os.makedirs(tmp, exist_ok=True)
        raw = msgpack.packb(payload, use_bin_type=True)
        if _zstd is not None:
            raw = _zstd.ZstdCompressor(level=3).compress(raw)
        with open(os.path.join(tmp, "leaves.msgpack.zst"), "wb") as f:
            f.write(raw)
        manifest = {
            "step": step, "format_version": FORMAT_VERSION,
            "axes": _axes_json(axes_tree) if axes_tree else None,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)             # atomic commit
        _gc(ckpt_dir, keep)

    if block:
        _write()
        return None
    th = threading.Thread(target=_write, daemon=True)
    th.start()
    return th


def _axes_json(tree):
    if isinstance(tree, dict):
        return {k: _axes_json(v) for k, v in tree.items()}
    return None if tree is None else list(tree)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "MANIFEST.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def read_payload(ckpt_dir: str, step: int) -> dict:
    """The decoded leaves file of a checkpoint: ``{path: {shape, dtype,
    data}}``."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "leaves.msgpack.zst")
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] == ZSTD_MAGIC:
        if _zstd is None:
            raise RuntimeError(f"{path} is zstd-compressed but the "
                               "'zstandard' package is not installed "
                               "(pip install zstandard)")
        raw = _zstd.ZstdDecompressor().decompress(raw)
    return _msgpack().unpackb(raw, raw=False)


def restore(ckpt_dir: str, step: int, skeleton, shardings=None):
    """Restore into ``skeleton``'s structure, as host tensors.
    ``shardings`` (a ``torch.device``, or a tree of them shaped like
    ``skeleton``) places every leaf, whole, on its device instead: the
    elastic re-layout onto the current devices."""
    flat = {k: _tensor(rec)
            for k, rec in read_payload(ckpt_dir, step).items()}
    if shardings is not None:
        devs = dict.fromkeys(flat, shardings) if isinstance(
            shardings, (str, torch.device)) else _flatten(shardings)
        flat = {k: flat[k].to(d) for k, d in devs.items()}
    return _unflatten(flat, skeleton)


def manifest(ckpt_dir: str, step: int) -> dict:
    tag = f"step_{step:08d}"
    with open(os.path.join(ckpt_dir, tag, "MANIFEST.json")) as f:
        return json.load(f)
