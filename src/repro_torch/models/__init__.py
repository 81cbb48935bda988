"""The paper's client CNN zoo, its label-conditional image generator, and
the distilled server LM (dense decoder family)."""
