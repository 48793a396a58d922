"""Batched CTC prefix beam search on the log-probs' device (counterpart of
convasr_tpu/ops/beam_device.py), in plain PyTorch: on the card the
hypotheses stay in device memory until the final top-K token ids.

The JAX package writes this as a scan of `_step` vmapped over the batch; here
the batch is a leading dimension of every state tensor, (B, K, ...), and the
scan a Python loop over frames. Each frame expands K beams x (top-N chars +
blank + repeat) into M = K * (N + 2) candidates, merges candidates with
equal prefix hashes exactly (a dense (B, M, M) equality matrix and a masked
logsumexp), keeps the top K merged rows, and rebuilds their prefix buffers.
An optional dense char-bigram table (decode/beam.char_lm_table) adds
alpha * logP(c | last char) + beta to every prefix extension.

What the port keeps bit for bit, so that tokens and lengths equal the JAX
package's:
- prefix hashes are uint32 with a wrapping multiply-add; they ride in int64
  and are masked with 0xFFFFFFFF after each multiply-add, so the equality
  merge sees the JAX values, sentinels included;
- `lax.top_k` and the stable `jnp.argsort` put the lowest index first among
  equal values, and spare beam slots are filled from the -1e30 ties; a stable
  descending `torch.sort` does the same (`torch.topk` promises no order among
  ties);
- the JAX package selects with one-hot masked sums of exactly one term,
  which equal a gather bit for bit; the port gathers.

The loop launches a few dozen small kernels a frame on the card (PERF.md);
no TPU kernel exists here.
"""
import torch

NEG_INF = -1e30
HASH_MULT = 1000003
HASH_MASK = 0xFFFFFFFF


def _logsumexp2(a, b):
    m = torch.maximum(a, b)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
    return torch.where(m <= NEG_INF / 2, NEG_INF, out)


def _top(x, k):
    """Indices of the k largest along the last axis, the lowest index first
    among equal values (lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _step(state, lp_t, active, blank_id: int, K: int, N: int, L: int, lm=None):
    """One beam step for every row: state (B, K, ...) tensors, lp_t (B, C)
    float32 log-probs of the frame, active (B,) bool (frozen rows pass
    through unchanged)."""
    prefixes, lengths, hashes, last, p_b, p_nb = state
    B, C = lp_t.shape
    dev = lp_t.device

    # top-N candidate characters this frame; the blank among them is masked
    top_c = _top(lp_t, min(N + 1, C))[:, :N + 1]                        # (B, N+1)
    top_lp = lp_t.gather(1, top_c)
    cand_lp = torch.where(top_c == blank_id, NEG_INF, top_lp)

    p_tot = _logsumexp2(p_b, p_nb)                                     # (B, K)

    # candidates in (K, J) layout: kind 0 = blank (same prefix, to p_b),
    # 1 = repeat of the last char (same prefix, to p_nb), 2.. = extension by
    # cand_c[j-2] (new prefix, to p_nb)
    J = top_c.shape[1] + 2
    M = K * J
    kind = torch.arange(J, device=dev)[None, None, :]                  # (1, 1, J)

    blank_lp = lp_t[:, blank_id]                                       # (B,)
    last_lp = torch.where(last >= 0, lp_t.gather(1, last.clamp(min=0).long()), NEG_INF)

    cand_char = torch.cat([torch.full((B, 2), -1, dtype=top_c.dtype, device=dev), top_c],
                          1)[:, None, :]                               # (B, 1, J)
    cand_char_lp = torch.cat([torch.full((B, 2), NEG_INF, device=dev), cand_lp],
                             1)[:, None, :]

    ext_hash = (hashes[:, :, None] * HASH_MULT + (cand_char + 1)) & HASH_MASK
    new_hash = torch.where(kind >= 2, ext_hash, hashes[:, :, None])     # (B, K, J)

    pb_contrib = torch.where(kind == 0, (p_tot + blank_lp[:, None])[:, :, None], NEG_INF)
    repeat_contrib = torch.where((kind == 1) & (last >= 0)[:, :, None],
                                 (p_nb + last_lp)[:, :, None], NEG_INF)
    is_repeat_ext = cand_char == last[:, :, None]
    ext_src = torch.where(is_repeat_ext, p_b[:, :, None], p_tot[:, :, None])
    ext_contrib = torch.where(kind >= 2, ext_src + cand_char_lp, NEG_INF)
    if lm is not None:
        # char-bigram shallow fusion: every extension pays
        # alpha * logP(c | last char of the parent) + beta
        lm_table, lm_alpha, lm_beta = lm
        V = lm_table.shape[1]
        ctx_rows = lm_table[torch.where(last >= 0, last, V).long()]    # (B, K, V)
        in_vocab = (cand_char >= 0) & (cand_char < V)
        lm_lp = torch.where(in_vocab, ctx_rows.gather(
            2, cand_char.clamp(0, V - 1).expand(B, K, J)), 0.0)
        ext_contrib = torch.where(kind >= 2, ext_contrib + lm_alpha * lm_lp + lm_beta,
                                  ext_contrib)
    pnb_contrib = torch.where(kind == 1, repeat_contrib, ext_contrib)
    pnb_contrib = torch.where(kind == 0, NEG_INF, pnb_contrib)

    # a dead parent kills its candidates; rows with no mass get a sentinel
    # hash unique to the row so that they merge with nothing
    parent_dead = (p_tot <= NEG_INF / 2)[:, :, None]
    pb_contrib = torch.where(parent_dead, NEG_INF, pb_contrib)
    pnb_contrib = torch.where(parent_dead, NEG_INF, pnb_contrib)
    row_dead = (pb_contrib <= NEG_INF / 2) & (pnb_contrib <= NEG_INF / 2)
    row_id = torch.arange(M, device=dev)
    sentinel = HASH_MASK - row_id
    new_hash = torch.where(row_dead, sentinel.view(1, K, J), new_hash)

    # merge rows with equal prefix hash: dense pairwise, no sort
    h = new_hash.reshape(B, M)
    pb = pb_contrib.reshape(B, M)
    pnb = pnb_contrib.reshape(B, M)
    same = h[:, :, None] == h[:, None, :]                              # (B, M, M)

    def masked_lse(v):
        mv = torch.where(same, v[:, None, :], NEG_INF)
        m = mv.max(-1).values
        m = torch.where(m <= NEG_INF / 2, NEG_INF, m)
        shifted = torch.exp(torch.clamp(mv - m[:, :, None], -80.0, 0.0))
        shifted = torch.where(mv <= NEG_INF / 2, 0.0, shifted)
        s = shifted.sum(-1)
        out = m + torch.log(torch.clamp(s, min=1e-30))
        return torch.where(s <= 0.0, NEG_INF, out)

    merged_pb = masked_lse(pb)
    merged_pnb = masked_lse(pnb)
    # one representative per hash group, the smallest row index; the others
    # die completely (mass and hash), since the top K fills spare slots from
    # the -1e30 ties
    first_idx = torch.where(same, row_id, M).min(-1).values
    canonical = first_idx == row_id
    merged_pb = torch.where(canonical, merged_pb, NEG_INF)
    merged_pnb = torch.where(canonical, merged_pnb, NEG_INF)
    h = torch.where(canonical, h, sentinel)
    score = torch.where(canonical, _logsumexp2(merged_pb, merged_pnb), NEG_INF)

    top_rows = _top(score, K)                                          # (B, K) into M
    new_parent = top_rows // J
    new_char = cand_char.expand(B, K, J).reshape(B, M).gather(1, top_rows).to(torch.int32)
    new_hashes = h.gather(1, top_rows)
    new_pb = merged_pb.gather(1, top_rows)
    new_pnb = merged_pnb.gather(1, top_rows)

    # rebuild the prefix buffers from the parents
    base_prefix = prefixes.gather(1, new_parent[:, :, None].expand(B, K, L))
    base_len = lengths.gather(1, new_parent)
    parent_last = last.gather(1, new_parent)
    write_pos = torch.clamp(base_len, max=L - 1)
    extends = new_char >= 0
    new_prefixes = torch.where(
        (torch.arange(L, device=dev)[None, None, :] == write_pos[:, :, None])
        & extends[:, :, None], new_char.clamp(min=0)[:, :, None], base_prefix)
    new_lengths = torch.clamp(base_len + extends.to(base_len.dtype), max=L - 1)
    new_last = torch.where(extends, new_char, parent_last)

    out = (new_prefixes, new_lengths, new_hashes, new_last, new_pb, new_pnb)
    # freeze the state of rows past their valid length
    return tuple(torch.where(active.view((B,) + (1,) * (a.ndim - 1)), a, b)
                 for a, b in zip(out, state))


def beam_carry_init(B: int, K: int, L: int, device=None):
    """Beam state of B rows, (B, K, ...) tensors: beam 0 is the live empty
    prefix, the other beams are dead and carry distinct sentinel hashes so
    that they can never merge with it. The state beam_search_device loops
    over, and a streaming engine's carried state."""
    row_hash = torch.arange(K, dtype=torch.int64, device=device) + 0x7FFFFFF0
    row_hash[0] = 1
    p_b = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    p_b[:, 0] = 0.0
    return (torch.zeros((B, K, L), dtype=torch.int32, device=device),     # prefixes
            torch.zeros((B, K), dtype=torch.int32, device=device),        # lengths
            row_hash[None].repeat(B, 1),                                  # hashes
            torch.full((B, K), -1, dtype=torch.int32, device=device),     # last char
            p_b,
            torch.full((B, K), NEG_INF, dtype=torch.float32, device=device))  # p_nb


def beam_carry_steps(state, lp_seg, active, blank_id: int, cutoff_top_n: int, lm=None):
    """Advance carried beam state by the S frames of lp_seg (B, S, C); rows
    where active (B,) is False pass through unchanged. Feeding an utterance
    through this in chunks gives the hypotheses of one beam_search_device
    call. lm: (table (V+1, V) float32 on the state's device, alpha, beta)."""
    N = min(cutoff_top_n, lp_seg.shape[-1] - 1)
    K, L = state[0].shape[1], state[0].shape[2]
    for t in range(lp_seg.shape[1]):
        state = _step(state, lp_seg[:, t].to(torch.float32), active, blank_id, K, N, L, lm=lm)
    return state


def beam_carry_best(state, compact_tokens: bool = True, num_classes: int = 256):
    """Best hypothesis of each row of carried state: (tokens (B, L),
    lengths (B,), scores (B,)), the first of equal scores."""
    prefixes, lengths, _, _, p_b, p_nb = state
    score = _logsumexp2(p_b, p_nb)                                     # (B, K)
    best = score.argmax(-1, keepdim=True)
    toks = prefixes.gather(1, best[:, :, None].expand(-1, -1, prefixes.shape[2]))[:, 0]
    lens = lengths.gather(1, best)[:, 0]
    sc = score.gather(1, best)[:, 0]
    if compact_tokens:
        toks = toks.to(torch.uint8 if num_classes <= 256 else torch.int16)
    return toks, lens, sc


def beam_search_device(log_probs: torch.Tensor, input_lengths: torch.Tensor, blank_id: int,
                       beam_width: int = 16, cutoff_top_n: int = 8, max_len: int = 256,
                       lm_table=None, lm_alpha: float = 0.3, lm_beta: float = 0.0,
                       compact_tokens: bool = False):
    """Batched prefix beam search where log_probs lie.

    log_probs: (B, T, C) log-softmax; input_lengths: (B,) int frames.
    Optional lm_table (V+1, V): dense char-bigram log-probs
    (decode/beam.char_lm_table) for shallow fusion. Returns tokens
    (B, K, max_len) int32, valid up to `lengths`, lengths (B, K) int32 and
    scores (B, K) float32, best beam first. compact_tokens=True casts the
    tokens to uint8 (C <= 256) or int16, a quarter or half the bytes for a
    host fetch; ids are < C, so the cast is lossless."""
    B, T, C = log_probs.shape
    K, N, L = beam_width, min(cutoff_top_n, C - 1), max_len
    dev = log_probs.device
    lm = None if lm_table is None else (
        torch.as_tensor(lm_table, dtype=torch.float32).to(dev), lm_alpha, lm_beta)
    xlen = torch.as_tensor(input_lengths).to(device=dev)
    lp = log_probs.to(torch.float32)
    state = beam_carry_init(B, K, L, device=dev)
    for t in range(T):
        state = _step(state, lp[:, t], t < xlen, blank_id, K, N, L, lm=lm)
    prefixes, lengths, _, _, p_b, p_nb = state
    score = _logsumexp2(p_b, p_nb)
    order = torch.sort(-score, dim=-1, stable=True).indices
    tokens = prefixes.gather(1, order[:, :, None].expand(B, K, L))
    lengths, score = lengths.gather(1, order), score.gather(1, order)
    if compact_tokens:
        tokens = tokens.to(torch.uint8 if C <= 256 else torch.int16)
    return tokens, lengths, score
