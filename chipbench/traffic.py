"""The general generator of a traffic mix: batches of prompts for a closed
loop, from the parameters of a workload file and the run's seed.

A workload file (``chipbench/workloads/<cell>.json``) gives:

- ``batch``: requests handed to ``ServingEngine.serve`` at once; the next
  batch is handed when it returns (a closed loop of one client);
- ``prompt_len``: tokens a prompt, the same for every prompt (document
  chunks cut to one length; the engine pads every prompt to the longest
  anyway);
- ``new_tokens``: tokens generated a request, greedily;
- ``check``: ``requests``, the least number of finished requests the
  comparison judges, and ``limits``, each compared number's limit.

Token ids are drawn uniformly from the whole vocabulary. Batch ``i`` of
one stream is the same for one seed whatever else the run does.
"""
from __future__ import annotations

import numpy as np

from chipbench.weights import stream_seed


class Traffic:
    def __init__(self, spec: dict, vocab: int, seed: int):
        self.spec, self.vocab, self.seed = spec, vocab, seed
        self.batch = int(spec["batch"])
        self.new_tokens = int(spec["new_tokens"])
        self.prompt_len = spec["prompt_len"]
        if not isinstance(self.prompt_len, int) or self.prompt_len < 1:
            raise ValueError(f"prompt_len {self.prompt_len!r}")

    def prompts(self, stream: str, i: int) -> np.ndarray:
        """(batch, prompt_len) int32 token ids of batch ``i`` of
        ``stream``."""
        rng = np.random.default_rng(stream_seed(self.seed, stream, i))
        return rng.integers(0, self.vocab, (self.batch, self.prompt_len),
                            dtype=np.int32)
