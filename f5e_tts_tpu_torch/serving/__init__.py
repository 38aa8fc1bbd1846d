"""Serving runtimes of the port: the dynamic batcher, the HTTP, raw-socket
and gRPC servers and clients, and the load generator (counterpart of
`f5e_tts_tpu/serving/`)."""
