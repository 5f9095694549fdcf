"""The decoder LM stack, dense family: ``config`` (the config dataclass),
``common`` (norms, RoPE, parameter init), ``attention`` (GQA, prefill,
decode; causal prefill through the CUDA flash kernel on the card), ``mlp``,
``transformer`` (the model as ``nn.Module``s, forward / prefill / decode),
``steps`` (prefill and decode factories) and ``convert`` (the JAX package's
parameter tree, as numpy arrays, into the port's modules)."""
