"""ray_tpu_torch.serve — the request context the serving layer reads
(``context``). The Serve deployment layer itself (controller, handles,
proxies) is not ported yet.
"""
