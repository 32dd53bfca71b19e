"""The single-session serving tier (style_transfer2_tpu/serve/): the aiohttp
web app and its in-process driver, which owns the port's StyleTransfer on
one device.

The browser protocol, the session, its schedule and its snapshots are
copies of the JAX package's modules; the driver and the app are the JAX
ones with the device work moved to torch. Run it with

    python -m style_transfer2_tpu_torch.serve.app [config.ini]

The config's `device` key picks the card ('cuda', the default) or the
plain PyTorch versions ('cpu').
"""
