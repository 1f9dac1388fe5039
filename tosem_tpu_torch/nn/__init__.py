"""Layers, attention and the routed expert layer (``moe``), as
``torch.nn.Module``s."""
