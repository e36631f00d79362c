"""Phase 26 of chip_smoke.py alone, on the card: the kernels built,
phase 6's GPT-2 small and phase 7's BERT-base from seed 0, then
`phase_resilience`.  Run from the checkout's root:

    python3 tools/smoke_phase26.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu_torch.convert import (  # noqa: E402
    bert_from_flax,
    causal_lm_from_flax,
    init_bert_params,
    init_causal_lm_params,
)
from analytics_zoo_tpu_torch.models.bert import (  # noqa: E402
    BERT_BASE,
    BERTClassifier,
)
from analytics_zoo_tpu_torch.ops.kernels import _build  # noqa: E402
from analytics_zoo_tpu_torch.serving.generation import (  # noqa: E402
    GPT2_SMALL,
    CausalLM,
)

if __name__ == "__main__":
    t0 = time.perf_counter()
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(_build.cuda_sources())
    gpt = CausalLM(**GPT2_SMALL, device="cuda")
    gpt.load_state_dict(causal_lm_from_flax(
        init_causal_lm_params(GPT2_SMALL, seed=0), GPT2_SMALL))
    gpt.eval()
    cfg = dict(BERT_BASE, num_classes=2)
    bert = BERTClassifier(**cfg, device="cuda", attn_impl="flash")
    bert.load_state_dict(bert_from_flax(init_bert_params(cfg, seed=0), cfg))
    bert.eval()
    print(f"set up in {time.perf_counter() - t0:.1f} s", flush=True)
    out = cs.phase_resilience(torch, 0, card, gpt, bert)
    print(f"phase 26 in {out['seconds']:.1f} s; script "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
