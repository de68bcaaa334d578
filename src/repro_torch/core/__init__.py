"""Core LDA math shared by training and serving."""
