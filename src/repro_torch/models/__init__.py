"""The language models: configs in :mod:`repro_torch.configs`, layers
here, serving in :mod:`repro_torch.serve.engine`, training in
:mod:`repro_torch.train.loop`.  Every family of the JAX package is
ported: ``dense``, ``moe``, ``ssm`` (rwkv6), ``hybrid`` (zamba2),
``encdec`` (whisper) and ``vlm`` (paligemma)."""
