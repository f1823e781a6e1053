"""Models of the port: ``vitfly.LSTMNetVIT`` (the paper's V(phi)) and its parts."""
