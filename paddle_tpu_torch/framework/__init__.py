"""Program IR, executor, passes and serialization — the port of
paddle_tpu/framework/ (the modules the serving slice needs)."""
