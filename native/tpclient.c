/* tpclient — thin native client for the twopaco server (cli/serve.py).
 *
 * Usage: tpclient <tool> [args...]      tool = twopaco|graphdump|naive
 *
 * Why native: every python process pays the interpreter + JAX import
 * and the device client's start-up before main() runs; the daemon holds
 * the warm runtime and this client only shuttles argv/stdout over a
 * unix socket (~ms). If the server socket is absent, the client spawns
 * the daemon (`python -m twopaco_tpu.cli.serve`) detached, waits for
 * the socket, then proceeds — first call slow, every later call warm.
 *
 * Protocol (see cli/serve.py): request u32le-length JSON; response
 * frames 'O'/'E' + u32le len + payload, final 'X' + u32le exit code.
 */
#include <errno.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <time.h>
#include <unistd.h>

/* name under $TMPDIR (else /tmp), as cli/serve.py's tempfile.gettempdir() */
static const char *tmp_file(char *buf, size_t n, const char *name) {
    const char *t = getenv("TMPDIR");
    snprintf(buf, n, "%s/%s", t && *t ? t : "/tmp", name);
    return buf;
}

static const char *sock_path(void) {
    static char buf[4096];
    const char *p = getenv("TWOPACO_SERVER_SOCKET");
    return p && *p ? p : tmp_file(buf, sizeof buf, "twopaco_tpu.sock");
}

static int connect_server(void) {
    int fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    struct sockaddr_un addr;
    memset(&addr, 0, sizeof addr);
    addr.sun_family = AF_UNIX;
    strncpy(addr.sun_path, sock_path(), sizeof addr.sun_path - 1);
    if (connect(fd, (struct sockaddr *)&addr, sizeof addr) != 0) {
        close(fd);
        return -1;
    }
    return fd;
}

static void spawn_server(void) {
    pid_t pid = fork();
    if (pid != 0) return; /* parent (or fork failure: just retry connect) */
    setsid();
    /* detach stdio so the daemon outlives the client's terminal */
    char log[4096];
    tmp_file(log, sizeof log, "twopaco_tpu_server.log");
    freopen(log, "a", stdout);
    freopen(log, "a", stderr);
    freopen("/dev/null", "r", stdin);
    const char *py = getenv("TWOPACO_PYTHON");
    execlp(py && *py ? py : "python", "python", "-m",
           "twopaco_tpu.cli.serve", (char *)NULL);
    _exit(127);
}

static int connect_or_boot(void) {
    int fd = connect_server();
    if (fd >= 0) return fd;
    spawn_server();
    /* daemon boot = interpreter + jax + device client start-up: allow minutes */
    double wait_s = 600.0;
    const char *w = getenv("TWOPACO_CLIENT_WAIT_S");
    if (w && *w) wait_s = atof(w);
    struct timespec ts = {0, 200 * 1000 * 1000};
    for (double t = 0; t < wait_s; t += 0.2) {
        nanosleep(&ts, NULL);
        fd = connect_server();
        if (fd >= 0) return fd;
    }
    fprintf(stderr, "tpclient: server did not come up on %s\n", sock_path());
    return -1;
}

static int send_all(int fd, const void *buf, size_t n) {
    const char *p = buf;
    while (n) {
        ssize_t k = write(fd, p, n);
        if (k <= 0) return -1;
        p += k;
        n -= (size_t)k;
    }
    return 0;
}

static int recv_all(int fd, void *buf, size_t n) {
    char *p = buf;
    while (n) {
        ssize_t k = read(fd, p, n);
        if (k <= 0) return -1;
        p += k;
        n -= (size_t)k;
    }
    return 0;
}

/* append s to *buf (cap *cap, len *len) JSON-escaped */
static void js_escape(char **buf, size_t *len, size_t *cap, const char *s) {
    for (const unsigned char *p = (const unsigned char *)s; *p; p++) {
        char tmp[8];
        int k;
        if (*p == '"' || *p == '\\')
            k = snprintf(tmp, sizeof tmp, "\\%c", *p);
        else if (*p < 0x20)
            k = snprintf(tmp, sizeof tmp, "\\u%04x", *p);
        else {
            tmp[0] = (char)*p;
            k = 1;
        }
        if (*len + (size_t)k + 1 > *cap) {
            *cap = (*cap + k + 1) * 2;
            *buf = realloc(*buf, *cap);
            if (!*buf) exit(12);
        }
        memcpy(*buf + *len, tmp, (size_t)k);
        *len += (size_t)k;
    }
}

static void js_append(char **buf, size_t *len, size_t *cap, const char *s) {
    size_t k = strlen(s);
    if (*len + k + 1 > *cap) {
        *cap = (*cap + k + 1) * 2;
        *buf = realloc(*buf, *cap);
        if (!*buf) exit(12);
    }
    memcpy(*buf + *len, s, k);
    *len += k;
}

int main(int argc, char **argv) {
    if (argc < 2) {
        fprintf(stderr,
                "usage: tpclient <twopaco|graphdump|naive|__shutdown__> "
                "[args...]\n");
        return 2;
    }
    int fd = connect_or_boot();
    if (fd < 0) return 3;

    size_t cap = 4096, len = 0;
    char *req = malloc(cap);
    char cwd[4096];
    if (!getcwd(cwd, sizeof cwd)) cwd[0] = 0;
    js_append(&req, &len, &cap, "{\"tool\":\"");
    js_escape(&req, &len, &cap, argv[1]);
    js_append(&req, &len, &cap, "\",\"cwd\":\"");
    js_escape(&req, &len, &cap, cwd);
    js_append(&req, &len, &cap, "\",\"argv\":[");
    for (int i = 2; i < argc; i++) {
        if (i > 2) js_append(&req, &len, &cap, ",");
        js_append(&req, &len, &cap, "\"");
        js_escape(&req, &len, &cap, argv[i]);
        js_append(&req, &len, &cap, "\"");
    }
    js_append(&req, &len, &cap, "]}");

    unsigned char hdr[4] = {(unsigned char)(len & 0xff),
                            (unsigned char)((len >> 8) & 0xff),
                            (unsigned char)((len >> 16) & 0xff),
                            (unsigned char)((len >> 24) & 0xff)};
    if (send_all(fd, hdr, 4) || send_all(fd, req, len)) {
        fprintf(stderr, "tpclient: send failed: %s\n", strerror(errno));
        return 3;
    }
    free(req);

    char *payload = NULL;
    size_t pcap = 0;
    for (;;) {
        unsigned char tag;
        unsigned char nb[4];
        if (recv_all(fd, &tag, 1) || recv_all(fd, nb, 4)) {
            fprintf(stderr, "tpclient: connection lost\n");
            return 3;
        }
        unsigned int n = (unsigned)nb[0] | ((unsigned)nb[1] << 8) |
                         ((unsigned)nb[2] << 16) | ((unsigned)nb[3] << 24);
        if (tag == 'X') {
            close(fd);
            return (int)n;
        }
        if (n > pcap) {
            pcap = n;
            payload = realloc(payload, pcap);
            if (!payload) return 12;
        }
        if (recv_all(fd, payload, n)) {
            fprintf(stderr, "tpclient: connection lost\n");
            return 3;
        }
        fwrite(payload, 1, n, tag == 'E' ? stderr : stdout);
        fflush(tag == 'E' ? stderr : stdout);
    }
}
