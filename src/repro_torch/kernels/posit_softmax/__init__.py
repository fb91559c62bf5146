"""Posit softmax: per row, decode -> stable f32 softmax -> encode."""
