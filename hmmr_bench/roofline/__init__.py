"""Operations and bytes from shapes, and the published peaks: the least
time of a kernel's call or of a whole clip or step."""
