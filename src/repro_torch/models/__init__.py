"""The decoder LM stack, dense and MoE families: ``config`` (the config
dataclass), ``common`` (norms, RoPE, parameter init), ``attention`` (GQA,
prefill, decode; causal prefill through the CUDA flash kernel on the
card), ``mlp`` (the dense MLP and the token-choice MoE), ``transformer``
(the model as ``nn.Module``s, forward / prefill / decode), ``steps``
(prefill and decode factories) and ``convert`` (the JAX package's
parameter tree, as numpy arrays, into the port's modules)."""
