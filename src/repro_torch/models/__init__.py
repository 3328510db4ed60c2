"""The LLM substrate's models (the port of ``repro.models``): ``common``,
``mlp``, ``attention``, ``rglru``, ``transformer``, and ``convert``, which
loads the reference's weights."""
