"""The plain reference: each configuration's forward pass in float32
PyTorch, with no kernel, cache or batching, written from the published
descriptions (Qwen2: decoder-only, RMSNorm, RoPE, grouped-query
attention with QKV bias, SwiGLU MLP, untied lm_head; Mixtral: the same
skeleton without the bias, its MLP a top-2 mixture of 8 SwiGLU experts,
the two chosen experts' outputs weighted by a softmax over their two
router logits, dropless).

It imports nothing of the program and reads only the weights that
``weights.py`` drew, dequantizing W8A16 matrices as ``q * scale`` in
float32. Departures from the published models, each also the port's:
RoPE rotates interleaved pairs ``(x[2i], x[2i+1])`` rather than HF's
halves (a fixed permutation of each head's q/k columns); the tokens are
bytes. TF32 is off, so every product is a float32 one. Work goes a
layer at a time, its weights converted to float32 for that layer only,
and attention a block of query rows at a time, so a full-width model
fits beside its bfloat16 or int8 weights.

``lowp`` computes the same pass in a lower precision than the
configuration states (the control of ``control.py``): ``"fp8"`` rounds
every matrix product's inputs to float8 e4m3 (weights per output
channel, activations per row), ``"int4"`` rounds every W8A16 matrix to
int4 with one scale per 128 input rows per output channel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from weights import dims

#: query rows a block of the attention holds: bounds the float32 logits
#: to H x 512 x T
Q_BLOCK = 512
FP8_MAX = 448.0
INT4_GROUP = 128


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Model:
    """The reference over one configuration's weights."""

    def __init__(self, cfg: dict, params: dict[str, torch.Tensor],
                 lowp: str = ""):
        strict_float32()
        self.cfg = cfg
        self.p = params
        self.d = dims(cfg)
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.lowp = lowp
        #: per row of the last pass, the least margin over the layers
        #: between the k-th and the (k+1)-th router logit (MoE only): a
        #: small one is a near tie, where rounding may pick another
        #: expert
        self.router_margin: torch.Tensor | None = None

    # -- weights ---------------------------------------------------------
    def w(self, name: str) -> torch.Tensor:
        """A matrix (or expert stack) in float32, in the control's
        precision when one is set."""
        q = self.p.get(name + ".q")
        if q is None:
            w = self.p[name].float()
            return _fp8_weight(w) if self.lowp == "fp8" else w
        w = q.float() * self.p[name + ".scale"]
        return _int4_weight(w) if self.lowp == "int4" else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.lowp == "fp8":
            x = _fp8_rows(x)
        return x @ w

    # -- pieces ------------------------------------------------------------
    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        r = torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps)
        return x * r * self.p[name].float()

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x ``[T, heads, hd]``; pairs (2i, 2i+1) rotate by pos *
        theta^(-2i/hd), the angles taken in float64."""
        hd = x.shape[-1]
        inv = self.theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                           device=x.device) / hd)
        ang = pos.double()[:, None] * inv[None, :]
        cos = torch.cos(ang).float()[:, None, :]
        sin = torch.sin(ang).float()[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape)

    def attention(self, q, k, v) -> torch.Tensor:
        """Causal grouped-query attention, q ``[T, H, hd]``, k/v ``[T,
        Hkv, hd]`` -> ``[T, H * hd]``, a block of queries at a time."""
        T, H, hd = q.shape
        g = H // k.shape[1]
        k = k.repeat_interleave(g, dim=1).transpose(0, 1)  # [H, T, hd]
        v = v.repeat_interleave(g, dim=1).transpose(0, 1)
        out = torch.empty((T, H, hd), device=q.device)
        for lo in range(0, T, Q_BLOCK):
            hi = min(T, lo + Q_BLOCK)
            qb = q[lo:hi].transpose(0, 1)  # [H, n, hd]
            s = (qb @ k[:, :hi].transpose(1, 2)) / math.sqrt(hd)
            mask = torch.arange(hi, device=q.device)[None, :] <= \
                torch.arange(lo, hi, device=q.device)[:, None]
            s.masked_fill_(~mask, float("-inf"))
            out[lo:hi] = (torch.softmax(s, -1) @ v[:, :hi]).transpose(0, 1)
        return out.reshape(T, H * hd)

    def dense_mlp(self, i: int, h: torch.Tensor) -> torch.Tensor:
        gate = self.mm(h, self.w(f"l{i}.w_gate"))
        up = self.mm(h, self.w(f"l{i}.w_up"))
        return self.mm(F.silu(gate) * up, self.w(f"l{i}.w_down"))

    def moe_mlp(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Dropless top-k routing: each token's k experts by router
        logit (ties to the lower index), weighted by a softmax over those
        k logits."""
        E, K = self.d["E"], self.d["K"]
        logits = h @ self.p[f"l{i}.gate"].float()
        val, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        wts = torch.softmax(val[:, :K], dim=-1)
        idx = idx[:, :K]
        margin = val[:, K - 1] - val[:, K]
        self.router_margin = margin if self.router_margin is None \
            else torch.minimum(self.router_margin, margin)
        out = torch.zeros_like(h)
        for e in range(E):
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            x = h[rows]
            wg = self._expert(f"l{i}.w_gate", e)
            wu = self._expert(f"l{i}.w_up", e)
            y = F.silu(self.mm(x, wg)) * self.mm(x, wu)
            del wg, wu
            y = self.mm(y, self._expert(f"l{i}.w_down", e))
            out.index_add_(0, rows, y * wts[rows, slot][:, None])
        return out

    def _expert(self, name: str, e: int) -> torch.Tensor:
        q = self.p.get(name + ".q")
        if q is None:
            w = self.p[name][e].float()
            return _fp8_weight(w) if self.lowp == "fp8" else w
        w = q[e].float() * self.p[name + ".scale"][e]
        return _int4_weight(w) if self.lowp == "int4" else w

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        q = self.p.get("embed.q")
        if q is None:
            return self.p["embed"][tokens].float()
        return q[tokens].float() * self.p["embed.scale"][tokens]

    # -- the pass ----------------------------------------------------------
    @torch.no_grad()
    def logits(self, tokens: list[int], last: int) -> torch.Tensor:
        """float32 logits ``[last, V]`` at the final ``last`` positions
        of ``tokens``, each the next-token distribution after the
        prefix that ends there."""
        d = self.d
        dev = self.p["norm_f"].device
        tok = torch.tensor(tokens, dtype=torch.long, device=dev)
        T = tok.shape[0]
        pos = torch.arange(T, device=dev)
        self.router_margin = None
        x = self.embed(tok)
        bias = bool(self.cfg.get("qkv_bias"))
        for i in range(d["L"]):
            h = self.norm(x, f"l{i}.attn_norm")
            q = self.mm(h, self.w(f"l{i}.wq"))
            k = self.mm(h, self.w(f"l{i}.wk"))
            v = self.mm(h, self.w(f"l{i}.wv"))
            if bias:
                q = q + self.p[f"l{i}.bq"].float()
                k = k + self.p[f"l{i}.bk"].float()
                v = v + self.p[f"l{i}.bv"].float()
            q = self.rope(q.view(T, d["H"], d["hd"]), pos)
            k = self.rope(k.view(T, d["Hkv"], d["hd"]), pos)
            a = self.attention(q, k, v.view(T, d["Hkv"], d["hd"]))
            del q, k, v
            x = x + self.mm(a, self.w(f"l{i}.wo"))
            h = self.norm(x, f"l{i}.mlp_norm")
            x = x + (self.moe_mlp(i, h) if self.cfg["family"] == "mixtral"
                     else self.dense_mlp(i, h))
        x = self.norm(x[T - last:], "norm_f")
        return self.mm(x, self.w("lm_head"))


def _fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """``[in, out]`` rounded to float8 e4m3 with one scale per output
    channel, back in float32."""
    s = w.abs().amax(-2, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / s).to(torch.float8_e4m3fn).float() * s


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """Activations rounded to float8 e4m3 with one scale per row."""
    s = x.abs().amax(-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _int4_weight(w: torch.Tensor) -> torch.Tensor:
    """``[in, out]`` rounded to int4 in groups of ``INT4_GROUP`` input
    rows per output channel, back in float32."""
    n_in, n_out = w.shape[-2], w.shape[-1]
    group = min(INT4_GROUP, n_in)
    g = w.reshape(*w.shape[:-2], n_in // group, group, n_out)
    s = g.abs().amax(-2, keepdim=True).clamp(min=1e-12) / 7.0
    return (torch.clamp(torch.round(g / s), -7, 7) * s).reshape(w.shape)
