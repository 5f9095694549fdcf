"""Launchers: ``serve`` (token serving: prefill + KV-cache decode; CG
solver serving) and ``train`` (the training CLI over
``train.trainer.Trainer``)."""
