"""Models of the port: NCHW nn.Modules with reference torch key names."""
