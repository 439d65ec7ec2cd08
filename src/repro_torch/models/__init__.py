"""Model code of the port (dense GQA + gated-MLP decoder stacks)."""
