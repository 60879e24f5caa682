"""Plain f32 LaViLa narrator (arXiv:2212.04501, ``VCLM_HF``), its caption
loss under LaViLa's freezing, and the FLOPs and least times of its train
step.

- Video tower: TimeSformer in Frozen-in-Time's divided form
  (arXiv:2102.05095, arXiv:2104.00650).  A uint8 clip [B, T, H, W, 3] is
  scaled to [0, 1] and normalized with the configuration's mean and std;
  each frame is cut into p x p patches, each flattened in (C, p_h, p_w)
  order and multiplied by ``visual.patch_embed.proj.weight`` [W, C, p, p]
  (no bias); every patch gets its spatial position (``pos_embed[0, 1:]``)
  and its frame's ``temporal_embed``; the CLS token ``cls_token +
  pos_embed[0, 0]`` goes in front, then ``ln_pre``.  A block::

      t = timeattn(norm3(x));  s = attn(norm1(x + t))
      x = x + s;  x = x + fc2(quick_gelu(fc1(norm2(x))))

  (the space branch adds to ``x``, not to the time branch's result).  Each
  divided attention is written as attention over all 1 + T n tokens under
  a mask, not by grouping: a patch query sees the CLS key and the patches
  of its own frame (space) or of its own grid position (time); the CLS
  query sees every key.  The tower ends with ``norm``; LayerNorm eps 1e-6.
- Pool: CoCa's multi-query attention: ``img_queries`` [Q, W_t] through
  ``img_attn_pool.norm`` and ``to_q`` (``pool_heads`` x ``pool_dim_head``),
  one k / v head from ``context_norm`` of the video tokens and ``to_kv``,
  ``to_out``, then ``img_attn_pool_norm``; LayerNorm eps 1e-5.
- Decoder: GPT-2 (HF's ``Conv1D``: ``x @ weight + bias``, weight [in,
  out]) over ``text[:, :-1]``, token and learned position embeddings; every
  ``cross_freq``-th block starts with the gated cross sub-block::

      x = x + tanh(alpha_cattn) * crossattention(ln_cross_attn(x), img)
      x = x + tanh(alpha_dense) * mlp_crossattention(ln_2_crossattention(x))

  (the cross MLP's activation is the squared ReLU), then causal
  self-attention and the tanh-GELU MLP; ``ln_f`` and the head tied to
  ``wte``; LayerNorm eps 1e-5.
- Loss: the NLL of ``text[:, 1:]`` under the logits, padding (id 0)
  left out, the mean over the batch's tokens.

LaViLa's narrator recipe freezes the LM (``--freeze-lm-vclm``: every GPT-2
leaf but the cross sub-blocks', the names that hold ``crossattention``,
``cross_attn`` or ``alpha_``) and the video tower (``--freeze-visual-vclm``):
a frozen weight is used detached, so it gets no gradient.  :func:`loss_and_grad` takes the batch
``traffic["reference"]["block"]`` clips at a time, each block's summed NLL
over the whole batch's token count, so the blocks' gradients add up to the
batch's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from portbench.flops import StepWork, attention_least_s, dense_flops
from portbench.reference.layers import ACTIVATIONS, dense, layer_norm

# --freeze-lm-vclm keeps an LM leaf training iff its name holds one of these
CROSS_LEAVES = ("crossattention", "cross_attn", "alpha_")
VISUAL = "visual."
LM = "text_decoder."
DEC = "text_decoder.transformer"
# the pool's to_q over its fan-in scale (weight_spec)
POOL_Q_GAIN = 4.0


def trained(name: str) -> bool:
    """Whether the recipe trains the weight ``name``."""
    if name.startswith(VISUAL):
        return False
    if name.startswith(LM):
        return any(t in name for t in CROSS_LEAVES)
    return True


def _vision_block_spec(prefix: str, width: int, mlp_ratio: int) -> list:
    hidden = mlp_ratio * width
    spec = []
    for norm in ("norm1", "norm2", "norm3"):
        spec += [(f"{prefix}.{norm}.weight", (width,), "one_plus", 0.1),
                 (f"{prefix}.{norm}.bias", (width,), "normal", 0.02)]
    for attn in ("attn", "timeattn"):
        spec += [(f"{prefix}.{attn}.qkv.weight", (3 * width, width),
                  "normal", width ** -0.5),
                 (f"{prefix}.{attn}.qkv.bias", (3 * width,), "normal", 0.02),
                 (f"{prefix}.{attn}.proj.weight", (width, width), "normal",
                  width ** -0.5),
                 (f"{prefix}.{attn}.proj.bias", (width,), "normal", 0.02)]
    return spec + [
        (f"{prefix}.mlp.fc1.weight", (hidden, width), "normal",
         width ** -0.5),
        (f"{prefix}.mlp.fc1.bias", (hidden,), "normal", 0.02),
        (f"{prefix}.mlp.fc2.weight", (width, hidden), "normal",
         hidden ** -0.5),
        (f"{prefix}.mlp.fc2.bias", (width,), "normal", 0.02)]


def _conv1d_spec(name: str, n_in: int, n_out: int) -> list:
    return [(f"{name}.weight", (n_in, n_out), "normal", n_in ** -0.5),
            (f"{name}.bias", (n_out,), "normal", 0.02)]


def _ln_spec(name: str, width: int) -> list:
    return [(f"{name}.weight", (width,), "one_plus", 0.1),
            (f"{name}.bias", (width,), "normal", 0.02)]


def weight_spec(config: dict, traffic: dict) -> list:
    """(name, shape, kind, scale) of every weight, under the port's
    state-dict names.  The gates draw ``1 + 0.1 N(0, 1)``: open, so that the
    video reaches the loss (at LaViLa's initial 0 every trained leaf but
    the gates would get a zero gradient).  The pool's ``to_q`` draws at
    :data:`POOL_Q_GAIN` times its fan-in scale: its scores then spread by
    about that much, so each query weighs its own few of the 2305 tokens
    (at the fan-in scale every query takes nearly the mean of them all, the
    pooled tokens are alike and the decoder's cross-attention scores flat,
    which leaves its queries' leaves without a gradient to compare)."""
    vw, tw = config["vision_width"], config["text_width"]
    p = config["patch_size"]
    n = (config["image_size"] // p) ** 2
    inner = config["pool_heads"] * config["pool_dim_head"]
    spec = [
        ("img_queries", (config["num_img_queries"], tw), "normal",
         tw ** -0.5),
        ("visual.cls_token", (1, 1, vw), "normal", vw ** -0.5),
        ("visual.pos_embed", (1, n + 1, vw), "normal", vw ** -0.5),
        ("visual.temporal_embed", (1, config["num_frames"], vw), "normal",
         0.02),
        ("visual.patch_embed.proj.weight", (vw, 3, p, p), "normal",
         (3 * p * p) ** -0.5),
        *_ln_spec("visual.ln_pre", vw)]
    for i in range(config["vision_layers"]):
        spec += _vision_block_spec(f"visual.blocks.{i}", vw,
                                   config["mlp_ratio"])
    spec += _ln_spec("visual.norm", vw)
    spec += [(f"{DEC}.wte.weight", (config["vocab_size"], tw), "normal",
              0.02),
             (f"{DEC}.wpe.weight", (config["max_positions"], tw), "normal",
              0.01)]
    for i in range(config["text_layers"]):
        b = f"{DEC}.h.{i}"
        if i % config["cross_freq"] == 0:
            spec += [(f"{b}.alpha_cattn", (), "one_plus", 0.1),
                     (f"{b}.alpha_dense", (), "one_plus", 0.1),
                     *_ln_spec(f"{b}.ln_cross_attn", tw),
                     *_conv1d_spec(f"{b}.crossattention.q_attn", tw, tw),
                     *_conv1d_spec(f"{b}.crossattention.c_attn", tw, 2 * tw),
                     *_conv1d_spec(f"{b}.crossattention.c_proj", tw, tw),
                     *_ln_spec(f"{b}.ln_2_crossattention", tw),
                     *_conv1d_spec(f"{b}.mlp_crossattention.c_fc", tw,
                                   4 * tw),
                     *_conv1d_spec(f"{b}.mlp_crossattention.c_proj", 4 * tw,
                                   tw)]
        spec += [*_ln_spec(f"{b}.ln_1", tw),
                 *_conv1d_spec(f"{b}.attn.c_attn", tw, 3 * tw),
                 *_conv1d_spec(f"{b}.attn.c_proj", tw, tw),
                 *_ln_spec(f"{b}.ln_2", tw),
                 *_conv1d_spec(f"{b}.mlp.c_fc", tw, 4 * tw),
                 *_conv1d_spec(f"{b}.mlp.c_proj", 4 * tw, tw)]
    spec += _ln_spec(f"{DEC}.ln_f", tw)
    spec += [*_ln_spec("img_attn_pool.norm", tw),
             *_ln_spec("img_attn_pool.context_norm", vw),
             ("img_attn_pool.to_q.weight", (inner, tw), "normal",
              POOL_Q_GAIN * tw ** -0.5),
             ("img_attn_pool.to_kv.weight",
              (2 * config["pool_dim_head"], vw), "normal", vw ** -0.5),
             ("img_attn_pool.to_out.weight", (tw, inner), "normal",
              inner ** -0.5),
             *_ln_spec("img_attn_pool_norm", tw)]
    return spec


# -- the model --------------------------------------------------------------

def divided_mask(frames: int, n: int, mode: str, device) -> torch.Tensor:
    """[1 + T n, 1 + T n] bool, True where a query (row) sees a key: the
    CLS row everything, the CLS column every row, and a patch the patches
    of its frame (``space``) or of its grid position (``time``)."""
    idx = torch.arange(frames * n, device=device)
    group = idx // n if mode == "space" else idx % n
    keep = torch.ones(1 + frames * n, 1 + frames * n, dtype=torch.bool,
                      device=device)
    keep[1:, 1:] = group[:, None] == group[None, :]
    return keep


def divided_attention(x: torch.Tensor, w: Dict[str, torch.Tensor],
                      prefix: str, heads: int, keep: torch.Tensor,
                      mm: Callable) -> torch.Tensor:
    b, s, width = x.shape
    d = width // heads
    qkv = dense(x, w, f"{prefix}.qkv", mm)
    q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2)
               for t in qkv.split(width, dim=-1))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    scores = scores.masked_fill(~keep, -math.inf)
    out = mm(scores.softmax(dim=-1), v)
    return dense(out.transpose(1, 2).reshape(b, s, width), w,
                 f"{prefix}.proj", mm)


def encode_video(config: dict, w: Dict[str, torch.Tensor],
                 video: torch.Tensor, mm: Callable) -> torch.Tensor:
    """uint8 [B, T, H, W, 3] -> the tower's tokens [B, 1 + T n, W]."""
    mean = torch.tensor(config["input_mean"], device=video.device)
    std = torch.tensor(config["input_std"], device=video.device)
    x = (video.float() / 255.0 - mean) / std
    b, t, h, wd, c = x.shape
    p, width = config["patch_size"], config["vision_width"]
    gh, gw = h // p, wd // p
    n = gh * gw
    x = x.reshape(b, t, gh, p, gw, p, c).permute(0, 1, 2, 4, 6, 3, 5)
    x = mm(x.reshape(b, t, n, c * p * p),
           w["visual.patch_embed.proj.weight"].reshape(width, -1).t())
    pos = w["visual.pos_embed"][0]
    x = x + pos[1:] + w["visual.temporal_embed"][0, :t, None]
    cls = (w["visual.cls_token"][0, 0] + pos[0]).expand(b, 1, width)
    x = layer_norm(torch.cat([cls, x.reshape(b, t * n, width)], dim=1), w,
                   "visual.ln_pre", 1e-6)
    space = divided_mask(t, n, "space", video.device)
    time = divided_mask(t, n, "time", video.device)
    act = ACTIVATIONS[config["activation"]]
    heads = config["vision_heads"]
    for i in range(config["vision_layers"]):
        pre = f"visual.blocks.{i}"
        tt = divided_attention(layer_norm(x, w, f"{pre}.norm3", 1e-6), w,
                               f"{pre}.timeattn", heads, time, mm)
        ss = divided_attention(layer_norm(x + tt, w, f"{pre}.norm1", 1e-6),
                               w, f"{pre}.attn", heads, space, mm)
        x = x + ss
        hid = act(dense(layer_norm(x, w, f"{pre}.norm2", 1e-6), w,
                        f"{pre}.mlp.fc1", mm))
        x = x + dense(hid, w, f"{pre}.mlp.fc2", mm)
    return layer_norm(x, w, "visual.norm", 1e-6)


def pool(config: dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
         mm: Callable) -> torch.Tensor:
    """The queries over the video tokens: [B, Q, W_t]."""
    b = tokens.shape[0]
    heads, dh = config["pool_heads"], config["pool_dim_head"]
    queries = layer_norm(w["img_queries"], w, "img_attn_pool.norm")
    q = mm(queries, w["img_attn_pool.to_q.weight"].t())
    q = q.reshape(-1, heads, dh).transpose(0, 1)  # [heads, Q, dh]
    kv = mm(layer_norm(tokens, w, "img_attn_pool.context_norm"),
            w["img_attn_pool.to_kv.weight"].t())
    k, v = kv[..., :dh], kv[..., dh:]  # [B, S, dh]
    sim = mm(q[None] / math.sqrt(dh), k.transpose(-1, -2)[:, None])
    out = mm(sim.softmax(dim=-1), v[:, None])  # [B, heads, Q, dh]
    out = out.transpose(1, 2).reshape(b, -1, heads * dh)
    out = mm(out, w["img_attn_pool.to_out.weight"].t())
    return layer_norm(out, w, "img_attn_pool_norm")


def _conv1d(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str,
            mm: Callable) -> torch.Tensor:
    return mm(x, w[f"{name}.weight"]) + w[f"{name}.bias"]


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, width = x.shape
    return x.reshape(b, s, heads, width // heads).transpose(1, 2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, mm: Callable) -> torch.Tensor:
    b, h, s, d = q.shape
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, -math.inf)
    out = mm(scores.softmax(dim=-1), v)
    return out.transpose(1, 2).reshape(b, s, h * d)


def decode(config: dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
           img: torch.Tensor, mm: Callable) -> torch.Tensor:
    """Teacher-forced logits [B, S, V] of ``tokens`` [B, S] given the
    pooled video ``img``."""
    tw, heads = config["text_width"], config["text_heads"]
    s = tokens.shape[1]
    x = w[f"{DEC}.wte.weight"][tokens.long()] + w[f"{DEC}.wpe.weight"][:s]
    gelu = ACTIVATIONS[config["text_activation"]]
    for i in range(config["text_layers"]):
        pre = f"{DEC}.h.{i}"
        if i % config["cross_freq"] == 0:
            y = layer_norm(x, w, f"{pre}.ln_cross_attn")
            q = _conv1d(y, w, f"{pre}.crossattention.q_attn", mm)
            kv = _conv1d(img, w, f"{pre}.crossattention.c_attn", mm)
            o = _attend(_heads(q, heads), _heads(kv[..., :tw], heads),
                        _heads(kv[..., tw:], heads), False, mm)
            y = _conv1d(o, w, f"{pre}.crossattention.c_proj", mm)
            x = x + torch.tanh(w[f"{pre}.alpha_cattn"]) * y
            y = layer_norm(x, w, f"{pre}.ln_2_crossattention")
            y = F.relu(_conv1d(y, w, f"{pre}.mlp_crossattention.c_fc", mm))
            y = _conv1d(y * y, w, f"{pre}.mlp_crossattention.c_proj", mm)
            x = x + torch.tanh(w[f"{pre}.alpha_dense"]) * y
        qkv = _conv1d(layer_norm(x, w, f"{pre}.ln_1"), w,
                      f"{pre}.attn.c_attn", mm)
        q, k, v = (_heads(t, heads) for t in qkv.split(tw, dim=-1))
        x = x + _conv1d(_attend(q, k, v, True, mm), w, f"{pre}.attn.c_proj",
                        mm)
        y = gelu(_conv1d(layer_norm(x, w, f"{pre}.ln_2"), w,
                         f"{pre}.mlp.c_fc", mm))
        x = x + _conv1d(y, w, f"{pre}.mlp.c_proj", mm)
    x = layer_norm(x, w, f"{DEC}.ln_f")
    return mm(x, w[f"{DEC}.wte.weight"].t())


def loss_and_grad(config: dict, traffic: dict, w: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], mm: Callable) -> float:
    """The caption loss of ``batch``; its gradient is added to the
    ``.grad`` of the trained leaves of ``w`` (the frozen ones are used
    detached).  Clips go ``traffic["reference"]["block"]`` at a time."""
    rows = traffic["reference"]["block"]
    used = {n: (t if trained(n) else t.detach())
            for n, t in w.items()}
    video, text = batch["video"], batch["text"].long()
    labels = text[:, 1:]
    count = (labels != 0).sum().clamp_min(1).float()
    total = 0.0
    for a in range(0, video.shape[0], rows):
        b = min(video.shape[0], a + rows)
        img = pool(config, used, encode_video(config, used, video[a:b], mm),
                   mm)
        logits = decode(config, used, text[a:b, :-1], img, mm)
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels[a:b, :, None])[..., 0]
        loss = (nll * (labels[a:b] != 0)).sum() / count
        loss.backward()
        total += float(loss.detach())
    return total


# -- FLOPs and least times ---------------------------------------------------

def step_flops(config: dict, traffic: dict) -> Dict[str, int]:
    """A train step's FLOPs by part, counted as the step does them: each
    tower's forward; the backward's products for the gradients it takes
    (an input's where something before it trains, a weight's where the
    weight trains), each the forward product's FLOPs.  The divided
    attention is its groups' sequences (1 + n rows, 1 + T) and the CLS
    query over every key; a causal product is not halved."""
    b, t = traffic["batch"], traffic["video"]["frames"]
    s_txt = traffic["text"]["context"] - 1
    vw, tw = config["vision_width"], config["text_width"]
    p, vh, th = config["patch_size"], config["vision_heads"], \
        config["text_heads"]
    n = (config["image_size"] // p) ** 2
    s_vis = 1 + t * n
    qn, inner = config["num_img_queries"], \
        config["pool_heads"] * config["pool_dim_head"]
    mlp = config["mlp_ratio"]

    def attn(batch, s_q, s_k, width):
        return 4 * batch * s_q * s_k * width

    vis_dense = (dense_flops(b * s_vis, vw, 3 * vw) * 2
                 + dense_flops(b * s_vis, vw, vw) * 2
                 + dense_flops(b * s_vis, vw, mlp * vw) * 2)
    vis_attn = (attn(b * t, 1 + n, 1 + n, vw) + attn(b * n, 1 + t, 1 + t, vw)
                + 2 * attn(b, 1, s_vis, vw))
    visual = (dense_flops(b * t * n, 3 * p * p, vw)
              + config["vision_layers"] * (vis_dense + vis_attn))
    pool_q = dense_flops(b * qn, tw, inner)
    pool_kv = dense_flops(b * s_vis, vw, 2 * config["pool_dim_head"])
    pool_attn = attn(b * config["pool_heads"], qn, s_vis,
                     config["pool_dim_head"])
    pool_out = dense_flops(b * qn, inner, tw)
    self_dense = (dense_flops(b * s_txt, tw, 3 * tw)
                  + dense_flops(b * s_txt, tw, tw)
                  + 2 * dense_flops(b * s_txt, tw, 4 * tw))
    self_attn = attn(b, s_txt, s_txt, tw)
    cross_q = dense_flops(b * s_txt, tw, tw)
    cross_rest = (dense_flops(b * qn, tw, 2 * tw)
                  + dense_flops(b * s_txt, tw, tw)
                  + 2 * dense_flops(b * s_txt, tw, 4 * tw))
    cross_attn = attn(b, s_txt, qn, tw)
    layers = config["text_layers"]
    crosses = len(range(0, layers, config["cross_freq"]))
    head = dense_flops(b * s_txt, tw, config["vocab_size"])
    text = (layers * (self_dense + self_attn)
            + crosses * (cross_q + cross_rest + cross_attn) + head)
    out = {"visual_fwd": visual,
           "pool_fwd": pool_q + pool_kv + pool_attn + pool_out,
           "text_fwd": text}
    # backward: the text stream's inputs need gradients from the first
    # cross sub-block on (not the embeddings' rows: the first cross
    # block's query input); the cross sub-blocks' weights and the
    # attentions' both operands
    out["text_bwd"] = (layers * (self_dense + 2 * self_attn)
                       + crosses * (2 * (cross_q + cross_rest)
                                    + 2 * cross_attn) + head - cross_q)
    # the pool: every gradient but the frozen video tokens'
    out["pool_bwd"] = 2 * (pool_q + pool_attn + pool_out) + pool_kv
    return out


def train_flops(config: dict, traffic: dict) -> int:
    return sum(step_flops(config, traffic).values())


def step_work(config: dict, traffic: dict) -> StepWork:
    """The forward's FLOPs, every tower once; the step's, with its partial
    backward, are :func:`train_flops`."""
    parts = step_flops(config, traffic)
    return StepWork(parts["visual_fwd"] + parts["pool_fwd"]
                    + parts["text_fwd"])


def divided_attention_least_s(config: dict, traffic: dict) -> float:
    """The least time of a step's divided attention, forward only: each
    layer's space sequences (B T of 1 + n rows) and time sequences (B n of
    1 + T), each q, k, v and out [rows, H D] in bf16 read or written once
    (``flops.attention_least_s``)."""
    b, t = traffic["batch"], traffic["video"]["frames"]
    n = (config["image_size"] // config["patch_size"]) ** 2
    heads = config["vision_heads"]
    d = config["vision_width"] // heads
    space, _ = attention_least_s(b * t, 1 + n, heads, d, False,
                                 products=2, tensors=4, rows=0)
    time, _ = attention_least_s(b * n, 1 + t, heads, d, False, products=2,
                                tensors=4, rows=0)
    return config["vision_layers"] * (space + time)
