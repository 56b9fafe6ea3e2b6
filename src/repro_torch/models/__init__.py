"""Model assembly of the port: layers, paged transformer, model facade."""
