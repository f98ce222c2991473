"""Serving: ``engine.TTSEngine`` (text -> waveform on the card),
``batcher.DynamicBatcher`` (request batching), ``http_api`` (stdlib HTTP
server) and ``app`` (optional Gradio UI)."""
