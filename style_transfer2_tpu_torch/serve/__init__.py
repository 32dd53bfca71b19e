"""The serving tiers (style_transfer2_tpu/serve/): the single-session web
app with its in-process driver, which owns the port's StyleTransfer on one
device; the pooled multi-session app, whose sessions are lanes of the
port's BatchedStyleTransfer buckets; and the router in front of either.

The browser protocol, the session, its schedule, its snapshots and the
router are copies of the JAX package's modules; the driver, the app and
the pool are the JAX ones with the device work moved to torch. Run them
with

    python -m style_transfer2_tpu_torch.serve.app [config.ini]
    python -m style_transfer2_tpu_torch.serve.pool [config.ini]
    python -m style_transfer2_tpu_torch.serve.router [config.ini]

The config's `device` key picks the card ('cuda', the default) or the
plain PyTorch versions ('cpu'); the router launches nothing on either.
"""
