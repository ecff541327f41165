"""The LM stack of the port: gemma2-2b (dense, local/global) serving."""
