"""The paper's client CNN zoo and its label-conditional image generator."""
