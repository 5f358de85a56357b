"""The plain reference: numpy campaigns that rebuild every table and draw
from the stream's raw columns, importing nothing of the program."""
