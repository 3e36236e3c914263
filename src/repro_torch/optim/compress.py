"""Gradient compression for the data-parallel all-reduce (the JAX
package's ``optim/compress.py``).

int8 block-quantized gradient exchange with **error feedback** (the
residual between the true gradient and its quantized transmission is
carried locally and added to the next step's gradient).  The reference
runs it under ``shard_map`` with an explicit ``psum``, so the wire format
is int8.  The port runs it over a :class:`~repro_torch.launch.mesh.
ShardMesh` from one process, as the sharded engine does its ``psum``: a
loop over the replicas, each quantizing its own gradient on its own
device; the int8 payloads go to the mesh axis's first device, where they
are summed as int32, together with the scales; the mean is then copied
back to every replica.  No ``torch.distributed``.

Off by default: the paper-faithful baseline exchanges f32/bf16 gradients.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map
from repro_torch.optim import adamw


def _q8(x: torch.Tensor, block: int = 256):
    q, scale = adamw._q8(x, block)
    return q, scale, tuple(q.shape)


def _dq8(q, scale, shape, n: int):
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def axis_devices(mesh, axis: str = "data") -> tuple:
    """The devices of the replicas along ``axis`` (the other axis at index
    0): replica ``r``'s gradient lives on the ``r``-th."""
    data, model = mesh.shape["data"], mesh.shape["model"]
    if axis == "data":
        return tuple(mesh.devices[i * model] for i in range(data))
    if axis == "model":
        return tuple(mesh.devices[j] for j in range(model))
    raise ValueError(f"mesh has no axis {axis!r} (axes {mesh.axis_names})")


def compressed_psum_mean(grads, err, mesh, axis: str = "data"):
    """All-reduce-mean per-replica gradients in int8 with error feedback.

    grads/err: lists, one tree per replica along ``axis`` (each on that
    replica's device).  Returns (mean_grads, new_err), lists of trees: the
    mean on every replica's device, each residual on its own."""
    devs = axis_devices(mesh, axis)
    n = len(devs)
    if len(grads) != n or len(err) != n:
        raise ValueError(f"{len(grads)} gradient and {len(err)} residual "
                         f"trees for {n} replicas")

    def one(*leaves):
        """One leaf of every replica's gradient, then of its residual."""
        sent_q, sent_s, new_err = [], [], []
        for g, e in zip(leaves[:n], leaves[n:]):
            g = g.float() + e
            q, scale, _ = _q8(g)
            new_err.append(g - _dq8(q, scale, g.shape, g.numel()))
            sent_q.append(q.to(devs[0]))          # the int8 payload
            sent_s.append(scale.to(devs[0]))
        summed, s_sum = sent_q[0].to(torch.int32), sent_s[0]
        for q, s in zip(sent_q[1:], sent_s[1:]):
            summed = summed + q.to(torch.int32)
            s_sum = s_sum + s
        # dequantize against the mean scale (absmax blocks are near-equal
        # across replicas after the first steps)
        mean = summed.float() * (s_sum / float(n)) / float(n)
        g0 = leaves[0]
        mean = mean.reshape(-1)[:g0.numel()].reshape(g0.shape)
        return [mean.to(d) for d in devs], new_err

    out = tree_map(one, *grads, *err)
    means = [tree_map(lambda o, r=r: o[0][r], out) for r in range(n)]
    errs = [tree_map(lambda o, r=r: o[1][r], out) for r in range(n)]
    return means, errs


def make_compressed_allreduce(mesh, axis: str = "data"):
    """Build ``fn(grads, err) -> (mean, new_err)`` where every gradient
    leaf carries a leading per-replica dim of size ``mesh.shape[axis]``:
    slice ``r`` goes to replica ``r``'s device, and the results come back
    stacked on the same leading dim, on the axis's first device (the mean
    repeated for every replica, each residual its own)."""
    devs = axis_devices(mesh, axis)

    def local(tree, r):
        return tree_map(lambda x: x[r].to(devs[r]), tree)

    def stack(trees):
        return tree_map(lambda *xs: torch.stack([x.to(devs[0]) for x in xs]),
                        *trees)

    def wrapped(grads, err):
        mean, new_err = compressed_psum_mean(
            [local(grads, r) for r in range(len(devs))],
            [local(err, r) for r in range(len(devs))], mesh, axis)
        return stack(mean), stack(new_err)
    return wrapped
