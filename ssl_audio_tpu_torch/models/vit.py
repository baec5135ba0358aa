"""Masked-autoencoder ViT encoder and decoder (port of
ssl_audio_tpu/models/vit.py; the reference's models/mae.py).

Parameter names are the reference's torch layout, the ones
ssl_audio_tpu/utils/torch_export.py export_vit_state_dict writes:
patch_embed.proj (a Conv2d, or the ConvStem's Sequential of [Conv, BN,
ReLU] triples and a final 1x1 Conv), cls_token, pos_embed, blocks.i.{norm1,
attn.qkv, attn.q_bias, attn.v_bias, attn.proj, norm2, mlp.fc1, mlp.fc2},
norm, and the decoder's decoder_embed, mask_token, decoder_pos_embed,
decoder_blocks.i, decoder_norm, decoder_pred.  The fixed sin-cos tables are
buffers: in the state dict, never trained.

Masking, as in JAX: all L tokens stay in the sequence and masked keys take
a -1e9 attention bias (key-bias masking, any mask ratio); or, with a static
`len_keep`, the masked tokens are gathered out and the blocks run on
1 + len_keep tokens (token drop).  Both take the same per-sample ranking of
uniform noise, so they mask the same tokens.  The noise, and DropPath's
keep masks, are inputs: the caller draws them (train/steps.py) or hands in
another package's draws; left out, they come from torch's global generator.

Attention goes through the fused kernels (ops/fused_attention.py) when the
model is built with fused_attention=True and the shape is in the kernels'
envelope; otherwise, and for return_attention, it is the fp32 einsum path.
The two differ at the ~1e-3 level: the kernels round the dot operands to
bf16, as the TPU kernel does.  Matrix products run in true fp32 (PyTorch's
default, TF32 off); the ConvStem's convolutions and the patch projection
run under ops.no_tf32() here, and whoever calls backward() on the output
does so under it as well (train/steps.py does).  LayerNorm is PyTorch's
two-pass one where flax takes E[x^2] - E[x]^2; both have eps 1e-6.

With spec.remat (--remat) the encoder's blocks, not the decoder's, run
under gradient checkpointing in train mode with gradients on (JAX
nn.remat): the same outputs and gradients, less activation memory, one
more forward of each block in the backward (_checkpointed).

Under the bf16 compute mode (models/precision.py: bf16 parameters and
input) the model runs as the JAX one does with bf16 parameters: linear
layers, convolutions and the einsum attention's products in bf16 (its
scores rounded to bf16, then softmax in fp32, the probabilities rounded to
bf16 for P V); the fused kernels' bf16 instantiation; LayerNorm and the
ConvStem's BatchNorm with fp32 statistics and a bf16 result; the fp32
position tables and mask token cast to the activation's type; the token
mask, the key bias and the masked mean pool in fp32 (JAX promotes the pool
to fp32 too); the reconstruction loss in fp32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ssl_audio_tpu_torch.models.batchnorm import BatchNorm2d
from ssl_audio_tpu_torch.ops import no_tf32
from ssl_audio_tpu_torch.ops.fused_attention import fused_attention
from ssl_audio_tpu_torch.ops.fused_attention import supports as fused_attention_supports
from ssl_audio_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed, get_sinusoid_encoding_table

NEG_INF = -1e9


def _to_2tuple(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


class PatchEmbed(nn.Module):
    """Conv patchifier: (B, C, F, T) -> (B, L, D), row-major (frequency outer)."""

    def __init__(self, patch_size, embed_dim: int, in_chans: int = 1):
        super().__init__()
        ps = _to_2tuple(patch_size)
        self.proj = nn.Conv2d(in_chans, embed_dim, ps, stride=ps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return self.proj(x).flatten(2).transpose(1, 2)


class ConvStem(nn.Module):
    """Early-convolution stem: 3x3 convolutions without bias, each followed by
    a BatchNorm with flax's training semantics and a ReLU, the channels
    doubling from embed_dim / 8; a final 1x1 projection.  Stride plans per
    patch size (reference mae.py:58-67)."""

    PLANS = {(16, 16): [2, 2, 2, 2], (16, 8): [2, 2, 2, (2, 1)], (8, 8): [2, 2, 2, 1],
             (64, 2): [2, (2, 1), (2, 1), (2, 1), (2, 1), (2, 1)]}

    @classmethod
    def strides_for(cls, patch_size) -> List[Tuple[int, int]]:
        ps = _to_2tuple(patch_size)
        if ps not in cls.PLANS:
            raise ValueError(f"Patch size {ps} is not supported by ConvStem")
        return [_to_2tuple(s) for s in cls.PLANS[ps]]

    def __init__(self, patch_size, embed_dim: int, in_chans: int = 1):
        super().__init__()
        assert embed_dim % 8 == 0
        layers: List[nn.Module] = []
        c_in, dim = in_chans, embed_dim // 8
        for s in self.strides_for(patch_size):
            layers += [nn.Conv2d(c_in, dim, 3, stride=s, padding=1, bias=False),
                       BatchNorm2d(dim, eps=1e-5, momentum=0.1), nn.ReLU()]
            c_in = dim
            if dim < embed_dim:
                dim *= 2
        layers.append(nn.Conv2d(c_in, embed_dim, 1))
        self.proj = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return self.proj(x).flatten(2).transpose(1, 2)


class AttentionKBiasZero(nn.Module):
    """Multi-head attention whose qkv projection has biases for q and v only
    (the k bias is pinned at zero).  key_bias: an additive (B, 1, 1, N)
    logit bias, the token mask."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, fused: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.fused = fused
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, key_bias: Optional[torch.Tensor] = None,
                return_attention: bool = False):
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x)
        if self.q_bias is not None:
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        attn = None
        if self.fused and not return_attention and fused_attention_supports(B, N, C, H):
            bias2 = (x.new_zeros(B, N, dtype=torch.float32) if key_bias is None
                     else key_bias[:, 0, 0, :].float())
            out = fused_attention(qkv, bias2, H)
        else:
            q, k, v = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
            attn = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
            if key_bias is not None:
                attn = attn + key_bias
            attn = torch.softmax(attn, dim=-1)
            out = torch.matmul(attn.to(v.dtype), v).transpose(1, 2).reshape(B, N, C)
        out = self.proj(out)
        if return_attention:
            return out, attn
        return out


class Mlp(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class DropPath(nn.Module):
    """Stochastic depth: in train mode with rate > 0, each sample's residual
    branch is kept with probability 1 - rate and scaled by 1 / (1 - rate).
    keep: the (B,) keep mask (1 = keep); None draws it from torch's global
    generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if keep is None:
            keep = torch.rand(x.shape[0], device=x.device) < 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return x * keep.to(x.dtype).view(shape) / (1.0 - self.rate)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, ln_eps: float = 1e-6, fused_attention: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = AttentionKBiasZero(dim, num_heads, fused=fused_attention)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, key_bias: Optional[torch.Tensor] = None,
                drop_keep: Optional[torch.Tensor] = None, return_attention: bool = False):
        """drop_keep: DropPath's keep masks (2, B), attention and MLP branch."""
        h = self.norm1(x)
        if return_attention:
            return self.attn(h, key_bias, return_attention=True)[1]
        k0, k1 = (None, None) if drop_keep is None else drop_keep
        x = x + self.drop_path(self.attn(h, key_bias), k0)
        return x + self.drop_path(self.mlp(self.norm2(x)), k1)


def _checkpointed(blk: Block, x: torch.Tensor, key_bias, keep) -> torch.Tensor:
    """blk(x, key_bias, keep) under torch.utils.checkpoint (non-reentrant):
    its activations are dropped and recomputed in the backward, a fused
    attention block's forward kernel launched again.  The block's parameters
    go in as explicit inputs and the recompute runs over them
    (functional_call): under the bf16 compute mode they are the step's bf16
    copies, which functional_call has swapped out again by the time the
    backward recomputes.  The RNG state is preserved only for a block that
    draws: every random number of a step is an input (DropPath's keep masks,
    the token noise; train/steps.py StepDraws), so the recompute sees the
    same values without it, and a step captured in a CUDA graph may not read
    the generators' state; a DropPath with rate > 0 and no keep mask draws
    from the global generator, and the recompute must draw the same."""
    names, tensors = zip(*blk.named_parameters())

    def run(x, key_bias, keep, *params):
        return torch.func.functional_call(blk, dict(zip(names, params)), (x, key_bias, keep))

    draws = keep is None and blk.drop_path.rate > 0
    return torch.utils.checkpoint.checkpoint(run, x, key_bias, keep, *tensors,
                                             use_reentrant=False, preserve_rng_state=draws)


def len_keep_for(length: int, mask_ratio):
    """floor(L * (1 - r)) in fp32, as the JAX package computes it: an int
    for a number; for a 0-d tensor ratio (a step's ratio in a CUDA graph,
    JAX's traced ratio) a 0-d int64 tensor on its device, by the same fp32
    operations, so nothing is read back to the host."""
    if torch.is_tensor(mask_ratio):
        return torch.floor(length * (1.0 - mask_ratio.float())).long()
    return int(np.floor(np.float32(length) * (np.float32(1.0) - np.float32(mask_ratio))))


def random_token_mask(noise: torch.Tensor, mask_ratio) -> torch.Tensor:
    """Per-sample binary mask (1 = removed) from uniform noise (B, L): rank
    the tokens by noise and remove the ranks >= floor(L * (1 - r)).  The
    ratio is a number or a 0-d tensor."""
    ranks = torch.argsort(torch.argsort(noise, dim=1, stable=True), dim=1, stable=True)
    return (ranks >= len_keep_for(noise.shape[1], mask_ratio)).float()


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize's "bicubic" along one axis
    (half-pixel centres; when it shrinks, the kernel is widened by the
    inverse scale: antialiasing), in fp32 as there."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() \
        / max(inv_scale, 1.0)
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_bicubic_static(table: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(table, (h, w, D), "bicubic") of an (H, W, D) grid,
    written out: torch's interpolate has another cubic (a = -0.75) and no
    antialiasing.  An axis whose size does not change is left as it is."""
    H, W, _ = table.shape
    if out_hw[0] != H:
        table = torch.einsum("hwd,ho->owd", table,
                             _resize_weights(H, out_hw[0]).to(table))
    if out_hw[1] != W:
        table = torch.einsum("hwd,wo->hod", table,
                             _resize_weights(W, out_hw[1]).to(table))
    return table


@dataclass(frozen=True)
class ViTSpec:
    img_size: Tuple[int, int] = (64, 96)
    patch_size: Tuple[int, int] = (16, 16)
    in_chans: int = 1
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    conv_stem: bool = False
    use_decoder: bool = False
    use_learned_pos_embd: bool = False
    decoder_embed_dim: int = 384
    decoder_depth: int = 4
    decoder_num_heads: int = 6
    mlp_ratio: float = 4.0
    norm_pix_loss: bool = False
    use_2d_dec_pos_embd: bool = False
    drop_path_rate: float = 0.0
    # attention through the kernels of ops/fused_attention.py, in encoder and
    # decoder blocks; shapes outside their envelope take the einsum path
    fused_attention: bool = False
    # gradient checkpointing of the encoder's blocks (--remat; JAX nn.remat):
    # in train mode with gradients on, each block keeps only its input and
    # runs its forward again in the backward (forward_encoder)
    remat: bool = False


class MaskedAutoencoderViT(nn.Module):
    def __init__(self, spec: ViTSpec):
        super().__init__()
        self.spec = s = spec
        gh, gw = self.grid_size()
        L = gh * gw
        stem = ConvStem if s.conv_stem else PatchEmbed
        # without the conv stem the patch projection is random and frozen:
        # build_encoder's caller leaves it out of the optimizer (train/optim.py)
        self.patch_embed = stem(s.patch_size, s.embed_dim, s.in_chans)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, s.embed_dim))
        if s.use_learned_pos_embd:
            self.pos_embed = nn.Parameter(torch.zeros(1, L + 1, s.embed_dim))
        else:
            self.register_buffer("pos_embed", torch.from_numpy(
                get_2d_sincos_pos_embed(s.embed_dim, (gh, gw), cls_token=True)[None]))
        rates = np.linspace(0, s.drop_path_rate, s.depth)
        self.blocks = nn.ModuleList([
            Block(s.embed_dim, s.num_heads, s.mlp_ratio, drop_path=float(rates[i]),
                  fused_attention=s.fused_attention) for i in range(s.depth)])
        self.norm = nn.LayerNorm(s.embed_dim, eps=1e-6)
        if s.use_decoder:
            self.decoder_embed = nn.Linear(s.embed_dim, s.decoder_embed_dim)
            self.mask_token = nn.Parameter(torch.zeros(1, 1, s.decoder_embed_dim))
            # the JAX model's table: 1-D unless use_2d_dec_pos_embd (its exporter
            # writes a 2-D table; the model is followed here)
            dtab = (get_2d_sincos_pos_embed(s.decoder_embed_dim, (gh, gw), cls_token=True)
                    if s.use_2d_dec_pos_embd
                    else get_sinusoid_encoding_table(L, s.decoder_embed_dim, cls_token=True))
            self.register_buffer("decoder_pos_embed", torch.from_numpy(dtab[None]))
            self.decoder_blocks = nn.ModuleList([
                Block(s.decoder_embed_dim, s.decoder_num_heads, s.mlp_ratio,
                      fused_attention=s.fused_attention) for _ in range(s.decoder_depth)])
            self.decoder_norm = nn.LayerNorm(s.decoder_embed_dim, eps=1e-6)
            self.decoder_pred = nn.Linear(s.decoder_embed_dim, self.img_patch_dim())

    @property
    def embed_dim(self) -> int:
        return self.spec.embed_dim

    def grid_size(self) -> Tuple[int, int]:
        return (self.spec.img_size[0] // self.spec.patch_size[0],
                self.spec.img_size[1] // self.spec.patch_size[1])

    def img_patch_dim(self) -> int:
        ph, pw = self.spec.patch_size
        return ph * pw * self.spec.in_chans

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """(N, C, F, T) -> (N, L, ph*pw*C), the reference's 'nchpwq->nhwpqc'."""
        ph, pw = self.spec.patch_size
        N, C, Fr, T = imgs.shape
        x = imgs.reshape(N, C, Fr // ph, ph, T // pw, pw).permute(0, 2, 4, 3, 5, 1)
        return x.reshape(N, (Fr // ph) * (T // pw), ph * pw * C)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """(N, L, ph*pw*C) -> (N, C, F, T), the inverse of patchify."""
        ph, pw = self.spec.patch_size
        h, w = self.grid_size()
        C = self.spec.in_chans
        x = x.reshape(x.shape[0], h, w, ph, pw, C).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(x.shape[0], C, h * ph, w * pw)

    def _pos_embed_for(self, Fr: int, T: int) -> torch.Tensor:
        gh, gw = self.grid_size()
        h0, w0 = Fr // self.spec.patch_size[0], T // self.spec.patch_size[1]
        if (h0, w0) == (gh, gw):
            return self.pos_embed
        patch_pe = _resize_bicubic_static(self.pos_embed[0, 1:].reshape(gh, gw, -1), (h0, w0))
        return torch.cat([self.pos_embed[:, :1], patch_pe.reshape(1, h0 * w0, -1)], dim=1)

    def prepare_tokens(self, x: torch.Tensor, mask_ratio=0, mask=None, len_keep=None,
                       noise=None):
        """-> (tokens with CLS, mask (B, L) 1 = removed, key_bias, ids_keep).
        Token drop when `len_keep` (an int, 0 <= len_keep < L) is given and
        `mask` is not; else key-bias masking, with `mask`, or a mask from
        `noise` at `mask_ratio` (a number, none at a Python 0, or a 0-d
        tensor)."""
        B, _, Fr, T = x.shape
        tokens = self.patch_embed(x)
        L = tokens.shape[1]
        pe = self._pos_embed_for(Fr, T)
        tokens = tokens + pe[:, 1:].to(tokens.dtype)
        ids_keep = key_bias = None
        token_drop = mask is None and len_keep is not None and 0 <= len_keep < L
        unmasked = isinstance(mask_ratio, (int, float)) and mask_ratio == 0
        if mask is None and noise is None and (token_drop or not unmasked):
            noise = torch.rand(B, L, device=x.device)
        if token_drop:
            ids_shuffle = torch.argsort(noise, dim=1, stable=True)
            mask = (torch.argsort(ids_shuffle, dim=1, stable=True) >= len_keep).float()
            ids_keep = ids_shuffle[:, :len_keep]
            tokens = torch.gather(tokens, 1, ids_keep[..., None].expand(-1, -1, tokens.shape[-1]))
        else:
            if mask is None:
                mask = (x.new_zeros(B, L, dtype=torch.float32) if unmasked
                        else random_token_mask(noise, mask_ratio))
            key_bias = F.pad((mask * NEG_INF)[:, None, None, :], (1, 0))   # CLS visible
        cls = (self.cls_token + pe[:, :1]).to(tokens.dtype).expand(B, -1, -1)
        return torch.cat([cls, tokens], dim=1), mask, key_bias, ids_keep

    def forward_encoder(self, x, mask_ratio=0, mask=None, len_keep=None, noise=None,
                        drop_keep=None):
        """drop_keep: per block, DropPath's keep masks (2, B), or None."""
        tokens, out_mask, key_bias, ids_keep = self.prepare_tokens(
            x, mask_ratio, mask, len_keep, noise)
        remat = self.spec.remat and self.training and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            keep = None if drop_keep is None else drop_keep[i]
            tokens = (_checkpointed(blk, tokens, key_bias, keep) if remat
                      else blk(tokens, key_bias, keep))
        return self.norm(tokens), out_mask, ids_keep

    def forward_decoder(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """tokens (B, 1+L, D) of the encoder, mask (B, L) 1 = removed: visible
        positions carry their encoding, masked ones the mask token."""
        d = self.decoder_embed(tokens)
        m = mask[..., None].to(d.dtype)
        patches = (1.0 - m) * d[:, 1:] + m * self.mask_token.to(d.dtype)
        x = torch.cat([d[:, :1], patches], dim=1) + self.decoder_pos_embed.to(d.dtype)
        for blk in self.decoder_blocks:
            x = blk(x, None)
        return self.decoder_pred(self.decoder_norm(x))[:, 1:]

    def forward_loss(self, imgs, pred, mask):
        """Masked-patch MSE in fp32 (reference mae.py:437-453)."""
        pred = pred.float()
        target = self.patchify(imgs).float()
        if self.spec.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=False)
            target = (target - mean) / (var + 1e-6) ** 0.5
        loss = ((pred - target) ** 2).mean(dim=-1)
        return (loss * mask).sum() / mask.sum().clamp_min(1.0)

    def forward(self, imgs: torch.Tensor, mask_ratio=0, mean_pool: bool = False,
                return_all: bool = False, masked_recon: bool = False, mask=None,
                len_keep: Optional[int] = None, noise: Optional[torch.Tensor] = None,
                drop_keep: Optional[Sequence[torch.Tensor]] = None):
        """-> latent (B, D): CLS, or with mean_pool the mean of the visible
        patch tokens; all tokens with return_all; (latent, reconstruction
        loss) with masked_recon."""
        tokens, out_mask, ids_keep = self.forward_encoder(
            imgs, mask_ratio, mask, len_keep, noise, drop_keep)
        if return_all:
            latent = tokens
        elif mean_pool:
            if ids_keep is not None:
                latent = tokens[:, 1:].mean(dim=1)
            else:
                w = 1.0 - out_mask
                latent = (tokens[:, 1:] * w[..., None]).sum(1) / w.sum(1, keepdim=True).clamp_min(1.0)
        else:
            latent = tokens[:, 0]
        if masked_recon:
            if ids_keep is not None:
                # kept encodings back to their positions; the masked slots are
                # replaced by the mask token in forward_decoder
                B, L = out_mask.shape
                D = tokens.shape[-1]
                full = tokens.new_zeros(B, L, D).scatter(
                    1, ids_keep[..., None].expand(-1, -1, D), tokens[:, 1:])
                tokens = torch.cat([tokens[:, :1], full], dim=1)
            pred = self.forward_decoder(tokens, out_mask)
            return latent, self.forward_loss(imgs, pred, out_mask)
        return latent

    def forward_viz(self, imgs: torch.Tensor, mask_ratio=0.75, mask=None, noise=None):
        """Reconstruction for visualisation (reference mae.py:471-480): ->
        (loss, recons with the visible patches copied from the input,
        errormap, mask (B, gh, gw)).  The mask comes from `mask` or from
        `noise` at `mask_ratio`, as in forward_encoder; needs the decoder."""
        tokens, out_mask, _ = self.forward_encoder(imgs, mask_ratio, mask, None, noise)
        pred = self.forward_decoder(tokens, out_mask)
        loss = self.forward_loss(imgs, pred, out_mask)
        visible = (out_mask == 0.0)[..., None]
        recons = self.unpatchify(torch.where(visible, self.patchify(imgs), pred))
        errormap = torch.sqrt((recons - imgs) ** 2)
        return loss, recons, errormap, out_mask.reshape(out_mask.shape[0], *self.grid_size())

    def forward_attn(self, imgs: torch.Tensor, mask_ratio=0, noise=None) -> torch.Tensor:
        """Every block's attention map (the fp32 einsum path), stacked:
        (depth, B, heads, N, N) (reference mae.py:482-489)."""
        tokens, _, key_bias, _ = self.prepare_tokens(imgs, mask_ratio, noise=noise)
        attns = []
        for blk in self.blocks:
            attns.append(blk(tokens, key_bias, return_attention=True))
            tokens = blk(tokens, key_bias)
        return torch.stack(attns)

    def get_intermediate_layers(self, imgs: torch.Tensor, mask_ratio=0,
                                noise=None) -> List[torch.Tensor]:
        """norm(tokens) after each block."""
        tokens, _, key_bias, _ = self.prepare_tokens(imgs, mask_ratio, noise=noise)
        out = []
        for blk in self.blocks:
            tokens = blk(tokens, key_bias)
            out.append(self.norm(tokens))
        return out


_SIZES = {
    # (embed_dim, depth, num_heads); the conv-stem variants take depth - 1
    "base": (768, 12, 12),
    "small": (384, 12, 6),
    "tiny": (192, 12, 3),
}


def get_mae_vit(size: str = "base", patch_size=None, c: bool = False, img_size=(64, 96),
                in_chans: int = 1, use_decoder: bool = False,
                use_learned_pos_embd: bool = False, **kw) -> MaskedAutoencoderViT:
    """The reference's get_mae_vit (mae.py:576-596)."""
    if size not in _SIZES:
        raise NotImplementedError(f"Size {size} is not supported")
    embed_dim, depth, num_heads = _SIZES[size]
    spec = ViTSpec(img_size=tuple(img_size), patch_size=_to_2tuple(patch_size or (16, 16)),
                   in_chans=in_chans, embed_dim=embed_dim, depth=depth - int(c),
                   num_heads=num_heads, conv_stem=c, use_decoder=use_decoder,
                   use_learned_pos_embd=use_learned_pos_embd, **kw)
    return MaskedAutoencoderViT(spec)


def init_vit_weights_(model: MaskedAutoencoderViT, generator: torch.Generator) -> nn.Module:
    """The JAX module's initialisers, drawn from `generator`: xavier-uniform
    linear layers and patch projection, lecun-normal (truncated) ConvStem
    convolutions, zero biases, normal(0.02) CLS and mask tokens and learned
    position table, LayerNorm and BatchNorm at 1 and 0.  The draws differ
    from jax.random's; tests hand both packages the same weights."""
    stem_convs = set()
    if isinstance(model.patch_embed, ConvStem):
        stem_convs = {id(m) for m in model.patch_embed.proj if isinstance(m, nn.Conv2d)}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                if id(m) in stem_convs:
                    fan_in = m.weight[0].numel()
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                else:
                    nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, AttentionKBiasZero) and m.q_bias is not None:
                nn.init.zeros_(m.q_bias)
                nn.init.zeros_(m.v_bias)
            elif isinstance(m, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
                m.reset_parameters()
        for name in ("cls_token", "mask_token", "pos_embed"):
            p = getattr(model, name, None)
            if isinstance(p, nn.Parameter):
                nn.init.normal_(p, std=0.02, generator=generator)
    return model
