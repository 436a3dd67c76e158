"""Frozen plain copies of what a language model's training step is made
of: the weight draw, the token stream, the forward pass and its loss,
AdamW and its schedule.  Plain ``torch`` and NumPy; nothing of the port."""
