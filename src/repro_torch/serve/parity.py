"""Token comparison of the engine against the sequential oracle, with the
tie rule.

The paged engine and ``generate_reference`` reduce over caches of other
lengths (the gathered pool against the dense cache), and the port against
the JAX package in other orders, so their logits agree only to the last
bits. Random-weight logits over a large vocabulary have small top-2
margins, so a greedy token may part at a near-tie. The rule: compare the
tokens until the first place they differ; along the shared tokens and at
that place the logit error must stay within a fixed limit for the compute
dtype (``LOGIT_LIMITS``); where the tokens part, the reference's top-2
margin must also be under that measured error (a tie). Anything else is a
fault: a large logit error fails whether or not the tokens part.

``record_logits(engine)`` makes an engine keep, per request, the fp32
logits each of its tokens was taken from; ``compare_tokens`` applies the
rule.
"""

from __future__ import annotations

from collections import defaultdict

import torch

# The largest logit difference the rule accepts between two paths that
# compute the same tokens, per compute dtype (a config's
# ``compute_dtype``), set between the readings of
# the sound paths and of planted faults (benchmarks_torch/parity_readings.py;
# a decode position off by one, a cache layer scaled by 1 + 2^-7). fp32,
# the smoke model: sound up to 4.8e-6, faults from 1.7e-2. bf16, SmolLM-360M
# at full width on an H100: sound up to 7.6e-2 (between two and three ulps of
# a logit near 4.7); the position fault from 0.81. The cache fault reads
# 8.6e-2 to 1.0e-1 in bf16, within the sound readings' resolution, so the
# rule is not what catches it: the swap's crc32 and the bit-exact round
# trip of serve/kv_cache.py are.
LOGIT_LIMITS = {"float32": 1e-4, "bfloat16": 0.1}


def record_logits(engine, uids=None) -> dict:
    """Wrap ``engine``'s prefill and decode dispatches so that every
    token a request gets has its fp32 logits ``(V,)`` (on the host)
    appended to ``out[uid]``, for the requests in ``uids`` (every request
    when None); returns ``out``."""
    out: dict = defaultdict(list)
    keep = None if uids is None else set(uids)

    def prefill(fn):
        def run(params, tokens, caches, block_table, start, n_valid, slot):
            res = fn(params, tokens, caches, block_table, start, n_valid, slot)
            req = engine.slot_req[slot]
            if (start + n_valid >= len(req.prompt)  # the first token's logits
                    and (keep is None or req.uid in keep)):
                out[req.uid].append(res[0][0, 0].float().cpu())
            return res
        return run

    def decode(fn):
        def run(params, tokens, caches, block_tables, lengths, mask, *poison):
            res = fn(params, tokens, caches, block_tables, lengths, mask, *poison)
            for s in torch.nonzero(mask.cpu()).flatten().tolist():
                uid = engine.slot_req[s].uid
                if keep is None or uid in keep:
                    out[uid].append(res[0][s, 0].float().cpu())
            return res
        return run

    engine._prefill_fn = prefill(engine._prefill_fn)
    engine._decode_fn = decode(engine._decode_fn)
    if engine._poison_fn is not None:
        engine._poison_fn = decode(engine._poison_fn)
    return out


def compare_tokens(tokens, ref_tokens, ref_logits, logits, *, limit: float) -> dict:
    """The tie rule on one request: ``tokens`` and ``logits`` (per token,
    ``(V,)``) from the path under test, ``ref_tokens`` and ``ref_logits``
    from the oracle, ``limit`` the largest logit error accepted
    (``LOGIT_LIMITS``). Returns ``identical``, ``at`` (the first index where
    the tokens differ, or None), ``err`` (max abs logit difference over the
    shared tokens, up to and including ``at``), ``margin`` (the reference's
    top-2 margin at ``at``) and ``ok``: ``err <= limit``, and the tokens
    identical or parting only at a tie (``margin < err``)."""
    n = min(len(tokens), len(ref_tokens))
    at = next((i for i in range(n) if tokens[i] != ref_tokens[i]), None)
    upto = n if at is None else at + 1
    if len(logits) < upto or len(ref_logits) < upto:
        raise ValueError(f"logits for {len(logits)} and {len(ref_logits)} tokens, "
                         f"want {upto} each")
    err = max((float((logits[i].float() - ref_logits[i].float()).abs().max())
               for i in range(upto)), default=0.0)
    if at is None:
        same = len(tokens) == len(ref_tokens)
        return dict(identical=same, at=None, err=err, margin=None,
                    ok=same and err <= limit)
    top2 = torch.topk(ref_logits[at].float(), 2).values
    margin = float(top2[0] - top2[1])
    return dict(identical=False, at=at, err=err, margin=margin,
                ok=err <= limit and margin < err)
