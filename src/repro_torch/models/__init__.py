"""The decoder LM stack, dense, MoE, SSM and hybrid families: ``config``
(the config dataclass), ``common`` (norms, RoPE, parameter init),
``attention`` (GQA, prefill, decode; causal prefill through the CUDA flash
kernel on the card), ``mlp`` (the dense MLP and the token-choice MoE),
``ssm`` (Mamba2 / SSD), ``rglru`` (RecurrentGemma's RG-LRU),
``transformer`` (the model as ``nn.Module``s, forward / prefill / decode),
``encdec`` (the audio encoder-decoder), ``steps`` (the loss, the train
step and the prefill and decode factories) and ``convert`` (the JAX
package's parameter tree, as numpy arrays, into the port's modules)."""
