"""Cells of the benchmark cut to a size a CPU test can run: the cell's
own configuration with every width and depth made small, and its traffic
with a small batch and short prompts."""
from chipbench.manifest import load_cell

DENSE = "stablelm-3b.score-4k"
MOE = "deepseek-moe-16b.score-512"


def tiny_cell(name: str, *, dtype: str = "bfloat16", batch: int = 4,
              prompt_len: int = 16, new_tokens: int = 1, requests: int = 6):
    cell = load_cell(name)
    a = cell.config["arch"]
    moe = a.get("moe") is not None
    a.update(num_layers=3 if moe else 2, d_model=64, num_heads=4,
             num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
             dtype=dtype)
    if moe:
        a["moe"].update(num_experts=8, top_k=2, expert_d_ff=32,
                        num_shared_experts=1, shared_d_ff=64, dense_d_ff=128)
    cell.traffic.update(batch=batch, prompt_len=prompt_len,
                        new_tokens=new_tokens)
    cell.traffic["check"]["requests"] = requests
    return cell
