"""Layers and attention, as ``torch.nn.Module``s."""
