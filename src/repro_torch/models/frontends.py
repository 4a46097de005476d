"""Modality frontends (counterpart of ``repro.models.frontends``).

audio (musicgen-large): the EnCodec codec is out of scope, the tokens
    ARE the EnCodec codes (vocab 2048), and the frontend is the identity
    on the token stream.
vision (internvl2-76b): the InternViT tower is out of scope; a training
    batch may carry (B, num_frontend_tokens, d_model) patch embeddings
    under "patch_embeds", which ``models.transformer.forward`` splices
    over the first positions of the embedded sequence.

``fake_patch_embeds`` draws stand-ins for them. The reference's other
function here, ``fake_cifar_batch``, is ported as
``repro_torch.data.synthetic.fake_cifar_batch``.
"""
from __future__ import annotations

import torch


def fake_patch_embeds(gen: torch.Generator, batch: int, num_tokens: int,
                      d_model: int,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(batch, num_tokens, d_model) stand-in patch embeddings, N(0, 1)
    times 0.02, drawn from ``gen`` on its device."""
    return torch.randn((batch, num_tokens, d_model), generator=gen,
                       device=gen.device, dtype=dtype) * 0.02
