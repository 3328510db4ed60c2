"""Prompt and generated tokens of the requests the window completed, over
the window's length (host clock)."""


def read(run):
    t = run.traffic
    done = sum(sum(b.ok) for b in run.batches)
    return done * (t.prompt_len + t.new_tokens) / run.window_s
