"""Detection losses (focal, smooth-L1, cross-entropy)."""
