"""Plain PyTorch references, one module a family of configurations; they
import nothing of the program under test."""
