"""Front doors of the port: ``serve`` (LM prefill + greedy decode)."""
