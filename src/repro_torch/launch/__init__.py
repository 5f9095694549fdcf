"""Launchers: ``serve`` (token serving: prefill + KV-cache decode)."""
