"""Config loading and the flax-to-torch weight converter."""
